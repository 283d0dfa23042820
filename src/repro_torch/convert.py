"""Parameter exchange between the JAX package's numpy dicts and the port.

Both packages keep the same parameter names (``w_c1``, ``b_fcb``, …, and
``v_<param>`` momentum state) and layouts (HWIO conv weights, ``(K, N)``
matmul weights, ``(c,)`` biases), so conversion is a checked copy.
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
