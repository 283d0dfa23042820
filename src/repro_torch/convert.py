"""Parameter exchange between the JAX package's numpy dicts and the port.

Both packages keep the same parameter names (``w_c1``, ``b_fcb``, …, and
``v_<param>`` momentum state; ``w_z``, ``conv_wx``, ``a_log``, … of the LM)
and layouts (HWIO conv weights, ``(K, N)`` matmul weights, ``(c,)``
biases), so conversion is a checked copy. The LM's stacked JAX layers are
unstacked into one module per layer, and so are the decode caches.
"""

from __future__ import annotations

import numpy as np
import torch


def _expected(graph) -> dict[str, tuple[int, ...]]:
    shapes = dict(graph.param_shapes())
    if graph.momentum:
        shapes.update({f"v_{p}": s for p, s in graph.param_shapes().items()})
    return shapes


def params_from_jax(params: dict, graph, device) -> dict[str, torch.Tensor]:
    """float32 tensors on ``device`` from a ``{name: array}`` dict.

    Every name and shape is checked against ``graph.param_shapes()`` (plus
    the ``v_`` entries when the graph uses momentum); the layout is kept.
    """
    want = _expected(graph)
    if set(params) != set(want):
        missing, extra = sorted(set(want) - set(params)), sorted(set(params) - set(want))
        raise ValueError(f"parameter names differ: missing {missing}, unexpected {extra}")
    out = {}
    for name, shape in want.items():
        v = params[name]
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(v.shape)}")
        if isinstance(v, torch.Tensor):
            out[name] = v.to(device=device, dtype=torch.float32)
        else:
            out[name] = torch.as_tensor(np.asarray(v, np.float32), device=device)
    return out


def params_to_numpy(params: dict) -> dict[str, np.ndarray]:
    """The way back: float32 numpy arrays of the same names and layouts."""
    return {k: v.detach().to("cpu", torch.float32).numpy() for k, v in params.items()}


def _flatten(tree, prefix: str = ""):
    """``("a.b.0.c", leaf)`` pairs of a nested dict / tuple pytree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _flatten(v, f"{prefix}.{k}" if prefix else str(k))


def _tensor(v) -> torch.Tensor:
    """A CPU tensor of the array's dtype; numpy bf16 (ml_dtypes) kept as bf16."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    a = np.array(v)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _unstack_units(tree) -> dict[str, torch.Tensor]:
    """Flat ``{name: tensor}`` of a JAX decoder pytree, each stacked
    ``units.<pos>`` leaf split along its leading axis into ``units.<pos>.<u>``."""
    flat = {}
    for key, v in _flatten(tree):
        t = _tensor(v)
        parts = key.split(".")
        i = parts.index("units") if "units" in parts else -1
        if i >= 0:
            head, rest = ".".join(parts[:i + 2]), ".".join(parts[i + 2:])
            for u in range(t.shape[0]):
                flat[f"{head}.{u}.{rest}"] = t[u]
        else:
            flat[key] = t
    return flat


def lm_params_from_jax(params: dict, cfg, device):
    """The port's LM parameters from the JAX ``init_lm`` pytree (numpy or torch leaves).

    Every stacked ``decoder.units[pos]`` leaf, of leading size ``n_units``,
    is unstacked into the per-layer tensors ``decoder.units.<pos>.<u>``.
    Names, shapes and dtypes are checked against the port's own
    :func:`~repro_torch.models.lm.init_lm`; dtypes are kept.
    """
    from repro_torch.models.lm import init_lm

    flat = _unstack_units(params)
    tree = init_lm(cfg, device="meta")
    want = dict(tree.named_parameters())
    if set(flat) != set(want):
        missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
        raise ValueError(f"parameter names differ: missing {missing}, unexpected {extra}")
    for name, p in want.items():
        t = flat[name]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: expected {tuple(p.shape)} {p.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    tree = tree.to_empty(device=device)
    with torch.no_grad():
        for name, p in tree.named_parameters():
            p.copy_(flat[name])
    return tree


def lm_cache_from_jax(cache: dict, cfg, device) -> dict:
    """The port's per-layer decode cache from a JAX ``init_cache`` /
    ``serve_step`` cache (numpy or torch leaves).

    Each stacked ``units[pos]`` leaf is unstacked into the caches of
    ``units[pos][u]``. Names, shapes and dtypes are checked against the
    port's own cache of the same batch, length and dtype (read off the
    leaves); dtypes are kept.
    """
    from repro_torch.models.transformer import init_decoder_cache

    flat = _unstack_units(cache)
    first = next((v for k, v in flat.items() if k.endswith((".k", ".conv"))), None)
    if first is None:
        raise ValueError("the cache holds no attention or SSM layer")
    # full-attention layers keep max_len positions, a window min(max_len, window)
    max_len = max((v.shape[2] for k, v in flat.items() if k.endswith(".k")), default=1)
    tree = init_decoder_cache(cfg, first.shape[0], max_len, first.dtype, device="meta")
    want = dict(_flatten(tree))
    if set(flat) != set(want):
        missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
        raise ValueError(f"cache names differ: missing {missing}, unexpected {extra}")
    for name, w in want.items():
        t = flat[name]
        if tuple(t.shape) != tuple(w.shape) or t.dtype != w.dtype:
            raise ValueError(f"{name}: expected {tuple(w.shape)} {w.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for unit_pos, unit in enumerate(tree["units"]):
        for u, c in enumerate(unit):
            for key in c:
                c[key] = flat[f"units.{unit_pos}.{u}.{key}"].to(device)
    for i, c in enumerate(tree["rem"]):
        for key in c:
            c[key] = flat[f"rem.{i}.{key}"].to(device)
    return tree
