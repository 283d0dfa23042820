"""Parameter exchange between the JAX package's numpy dicts and the port.

Both packages keep the same parameter names (``w_c1``, ``b_fcb``, …, and
``v_<param>`` momentum state; ``w_z``, ``conv_wx``, ``a_log``, … of the LM)
and layouts (HWIO conv weights, ``(K, N)`` matmul weights, ``(c,)``
biases), so conversion is a checked copy. The LM's stacked JAX layers are
unstacked into one module per layer.
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


def lm_params_from_jax(params: dict, cfg, device):
    """The port's LM parameters from the JAX ``init_lm`` pytree (numpy or torch leaves).

    Every stacked ``decoder.units[pos]`` leaf, of leading size ``n_units``,
    is unstacked into the per-layer tensors ``decoder.units.<pos>.<u>``.
    Names, shapes and dtypes are checked against the port's own
    :func:`~repro_torch.models.lm.init_lm`; dtypes are kept.
    """
    from repro_torch.models.lm import init_lm

    flat = {}
    for key, v in _flatten(params):
        t = _tensor(v)
        parts = key.split(".")
        if parts[:2] == ["decoder", "units"]:
            head, rest = ".".join(parts[:3]), ".".join(parts[3:])
            for u in range(t.shape[0]):
                flat[f"{head}.{u}.{rest}"] = t[u]
        else:
            flat[key] = t
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
