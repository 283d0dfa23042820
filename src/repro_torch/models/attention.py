"""GQA self-attention with full / sliding-window masking (``repro/models/attention.py``).

The prefill block: q, k and v projections (with the optional QKV bias and
q/k RMSNorm), RoPE, and attention through
:func:`repro_torch.kernels.ops.attention` — the hand-written flash-attention
kernel on the card, its plain version on the CPU — then the output
projection. GQA is native: k and v keep their ``n_kv_heads`` and are never
repeated. bf16 rounds where the JAX block rounds: after every projection and
bias add, after the q/k norms and after RoPE. ``backend="xla"`` takes the
blockwise route, which autograd goes through (the training step). The mesh branch of the JAX
block has no counterpart (the port has no mesh); the decode step and its KV
cache come with the decode slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.blocks import ParamTree, _dot, apply_rope, init_rmsnorm, normal, rms_norm


def init_attention(cfg, gen: torch.Generator | None, device, dtype=torch.bfloat16) -> ParamTree:
    """The JAX block's parameters, same names, shapes and distributions."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = d**-0.5
    p = {
        "wq": normal((d, hq * dh), std, gen, device, dtype),
        "wk": normal((d, hkv * dh), std, gen, device, dtype),
        "wv": normal((d, hkv * dh), std, gen, device, dtype),
        "wo": normal((hq * dh, d), (hq * dh) ** -0.5, gen, device, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, device)
        p["k_norm"] = init_rmsnorm(dh, device)
    return ParamTree(p)


def _project_qkv(x, params, cfg, positions):
    """-> q (B, Hq, S, Dh), k and v (B, Hkv, S, Dh); v is a transposed view."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _dot(x, params["wq"])
    k = _dot(x, params["wk"])
    v = _dot(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(b, s, hq, dh).transpose(1, 2)
    k = k.reshape(b, s, hkv, dh).transpose(1, 2)
    v = v.reshape(b, s, hkv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(x: torch.Tensor, params, cfg, *, window: int | None = None,
                    backend: str = "auto", block_kv: int = 512) -> torch.Tensor:
    """Training/prefill self-attention (causal). x: (B, S, D) -> (B, S, D).

    ``backend`` and ``block_kv`` go to :func:`repro_torch.kernels.ops.attention`
    (KV blocks of ``min(block_kv, S)``).
    """
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(x, params, cfg, positions)
    o = ops.attention(q, k, v, causal=True, window=window, backend=backend,
                      block_kv=min(block_kv, s))
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return _dot(o, params["wo"])
