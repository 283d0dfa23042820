"""Shared NN building blocks: the parameter tree, matmul, norms, RoPE, MLPs.

Counterpart of ``repro/models/blocks.py``. Parameters live in
:class:`ParamTree` modules that keep the JAX pytree's names, so a layer
reads ``p["w_z"]`` as the JAX code does and ``state_dict()`` keys are the
JAX paths. Matmuls accumulate in fp32 and round once to the activation
dtype; RoPE and the MLP activations are taken in fp32 and cast back once,
where the JAX code casts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ops import widen


class ParamTree(nn.Module):
    """Named parameters and sub-modules, read as ``p["name"]``.

    Inference only: parameters are created with ``requires_grad=False``.
    """

    def __init__(self, entries: dict):
        super().__init__()
        for k, v in entries.items():
            if isinstance(v, nn.Module):
                self.add_module(k, v)
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)


def param_pytree(tree: nn.Module):
    """A :class:`ParamTree`'s parameters as the JAX-style pytree that the
    training step and the optimizers take: nested dicts (for ``ParamTree``)
    and lists (for ``nn.ModuleList``) of plain tensors that share the
    parameters' storage. ``lm.forward`` reads either form."""
    if isinstance(tree, nn.ModuleList):
        return [param_pytree(m) for m in tree]
    out = {k: p.detach() for k, p in tree._parameters.items()}
    out.update({k: param_pytree(m) for k, m in tree._modules.items()})
    return out


def normal(shape, std: float, gen, device, dtype) -> torch.Tensor:
    """``(N(0, 1) * std).astype(dtype)`` from ``gen``; uninitialised on ``meta``."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device=device, dtype=dtype)
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Activation @ weight with fp32 accumulation, output in activation dtype.

    For bf16 on the card this needs
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
    False`` (set by :func:`repro_torch.kernels.ops.strict_fp32`); for fp32,
    TF32 off.
    """
    return torch.matmul(x, w).to(x.dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device, dtype=torch.float32) -> ParamTree:
    return ParamTree({"scale": torch.zeros((d,), dtype=dtype, device=device)})  # 1 + scale


def rms_norm(x: torch.Tensor, params, eps: float = 1e-6) -> torch.Tensor:
    xf = widen(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + widen(params["scale"]))).to(x.dtype)


def init_layernorm(d: int, device, dtype=torch.float32) -> ParamTree:
    return ParamTree({"scale": torch.ones((d,), dtype=dtype, device=device),
                      "bias": torch.zeros((d,), dtype=dtype, device=device)})


def layer_norm(x: torch.Tensor, params, eps: float = 1e-5) -> torch.Tensor:
    xf = widen(x)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def apply_norm(x, params, kind: str, eps: float):
    return rms_norm(x, params, eps) if kind == "rms" else layer_norm(x, params, eps)


def init_norm(d: int, kind: str, device, dtype=torch.float32) -> ParamTree:
    return init_rmsnorm(d, device, dtype) if kind == "rms" else init_layernorm(d, device, dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, D_head); positions: (S,) or (..., S) token positions."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # (d/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(widen(x), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(d: int, d_ff: int, act: str, gen, device, dtype=torch.bfloat16) -> ParamTree:
    std = d**-0.5
    p = {}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = normal((d, d_ff), std, gen, device, dtype)
    p["w_up"] = normal((d, d_ff), std, gen, device, dtype)
    p["w_down"] = normal((d_ff, d), d_ff**-0.5, gen, device, dtype)
    return ParamTree(p)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp(x: torch.Tensor, params, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(widen(_dot(x, params["w_gate"]))).to(x.dtype)
        h = h * _dot(x, params["w_up"])
    elif act == "geglu":
        h = _gelu(widen(_dot(x, params["w_gate"]))).to(x.dtype)
        h = h * _dot(x, params["w_up"])
    else:
        h = _gelu(widen(_dot(x, params["w_up"]))).to(x.dtype)
    return _dot(h, params["w_down"])
