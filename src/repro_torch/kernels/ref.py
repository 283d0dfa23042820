"""Sequential references for the port's kernels (from ``repro/kernels/ref.py``).

Slow and literal: the tests and ``chip_smoke.py`` hold the kernels and
their chunked plain versions against these.
"""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Dense softmax attention in fp32, GQA by repeating k and v; o in q's dtype.

    Rows with no visible key give 0, as the flash kernel does. The decode
    offsets of the JAX oracle come with the decode slice.
    """
    hq, sq, d = q.shape[1:]
    skv = k.shape[2]
    grp = hq // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / d**0.5
    kf = k.float().repeat_interleave(grp, dim=1)
    vf = v.float().repeat_interleave(grp, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * sm_scale
    q_ids = torch.arange(sq, device=q.device)[:, None]
    kv_ids = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_ids <= q_ids
    if window is not None:
        mask &= kv_ids > q_ids - window
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    out = p @ vf
    return torch.where(mask.any(dim=-1)[:, None], out, 0.0).to(q.dtype)


def ssd_ref(
    x: torch.Tensor,  # (B, H, S, P)
    la: torch.Tensor,  # (B, H, S)
    b: torch.Tensor,  # (B, G, S, N)
    c: torch.Tensor,  # (B, G, S, N)
    h0: torch.Tensor | None = None,  # (B, H, P, N)
) -> torch.Tensor:
    """Sequential SSD recurrence (the literal state-space model), fp32.

    h_t = exp(la_t) h_{t-1} + x_t b_t^T,  y_t = h_t c_t; y in x's dtype.
    """
    bb, h, s, p = x.shape
    n = b.shape[-1]
    grp = h // b.shape[1]
    bf = b.float().repeat_interleave(grp, dim=1)  # (B, H, S, N)
    cf = c.float().repeat_interleave(grp, dim=1)
    xf, laf = x.float(), la.float()
    state = h0.float() if h0 is not None else x.new_zeros((bb, h, p, n), dtype=torch.float32)
    ys = []
    for t in range(s):
        a = torch.exp(laf[:, :, t])[..., None, None]
        state = a * state + xf[:, :, t, :, None] * bf[:, :, t, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, :, t]))
    return torch.stack(ys, dim=2).to(x.dtype)
