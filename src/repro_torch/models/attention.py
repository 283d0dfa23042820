"""GQA self-attention with full / sliding-window masking (``repro/models/attention.py``).

The prefill block: q, k and v projections (with the optional QKV bias and
q/k RMSNorm), RoPE, and attention through
:func:`repro_torch.kernels.ops.attention` — the hand-written flash-attention
kernel on the card, its plain version on the CPU — then the output
projection. GQA is native: k and v keep their ``n_kv_heads`` and are never
repeated. bf16 rounds where the JAX block rounds: after every projection and
bias add, after the q/k norms and after RoPE. ``backend="xla"`` takes the
blockwise route, which autograd goes through (the training step). The mesh branch of the JAX
block has no counterpart (the port has no mesh).

The decode step (:func:`decode_attention_block`) projects one token with
the prefill's ``_project_qkv``, writes its k and v into the layer's KV
cache (:func:`init_kv_cache`) in place, at slot ``pos`` or, for a
sliding-window layer, ``pos % window`` (a ring buffer), and attends to the
cache densely in fp32 (:func:`_dense_decode_attention`). No kernel is on
this step, as none is on JAX's.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import widen
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


def init_kv_cache(cfg, batch: int, max_len: int, window: int | None,
                  dtype=torch.bfloat16, device=None) -> dict:
    """Cache for one attention layer. Sliding-window layers only keep the window."""
    length = min(max_len, window) if window is not None else max_len
    shape = (batch, cfg.n_kv_heads, length, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention_block(x: torch.Tensor, params, cfg, cache: dict, pos: int, *,
                           window: int | None = None):
    """One decode step: write the cache at ``pos`` and attend to the prefix.

    x (B, 1, D); ``pos`` is the index of the token, a Python int. The
    cache's k and v are updated in place (JAX donates them) and returned.
    Sliding-window layers store the cache as a ring buffer of size
    ``min(max_len, window)`` (slot ``pos % cache_len``). A ``pos`` past
    a cache that does not hold the whole window raises (without a window,
    or a ring shorter than the window, which would drop keys still in
    view), where JAX's update would clamp or wrap it silently.
    Returns (out (B, 1, D), cache).
    """
    b = x.shape[0]
    cache_len = cache["k"].shape[2]
    if pos < 0 or (pos >= cache_len and (window is None or cache_len < window)):
        raise IndexError(f"decode position {pos} is outside the KV cache of length "
                         f"{cache_len}")
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = _project_qkv(x, params, cfg, positions)
    slot = pos % cache_len if window is not None else pos
    cache["k"][:, :, slot] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, slot] = v[:, :, 0].to(cache["v"].dtype)

    slots = torch.arange(cache_len, device=x.device)
    if window is not None:
        # ring buffer: the absolute position of slot j is pos - ((pos - j) mod cache_len)
        kv_pos = pos - torch.remainder(pos - slots, cache_len)
        valid = kv_pos >= max(0, pos - window + 1)
    else:
        valid = slots <= pos
    o = _dense_decode_attention(q, cache["k"], cache["v"], valid)
    o = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return _dot(o, params["wo"]), cache


def _dense_decode_attention(q, k, v, valid):
    """Single-token attention over the whole cache: fp32 scores and values,
    ``-1e30`` at invalid slots, p zeroed there, the output in q's dtype.

    q (B, Hq, 1, Dh), k / v (B, Hkv, L, Dh), valid (L,) bool. GQA grouped:
    k and v are never repeated.
    """
    b, hq, _, dh = q.shape
    hkv = k.shape[1]
    grp = hq // hkv
    qf = widen(q).reshape(b, hkv, grp, dh)
    s = torch.einsum("bkgd,bkjd->bkgj", qf, widen(k)) * (dh**-0.5)
    s = torch.where(valid, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid, p, 0.0)
    o = torch.einsum("bkgj,bkjd->bkgd", p, widen(v))
    o = o / p.sum(dim=-1, keepdim=True)
    return o.reshape(b, hq, 1, dh).to(q.dtype)
