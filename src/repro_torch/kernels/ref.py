"""References for the port's kernels (from ``repro/kernels/ref.py``).

Dense or sequential and literal: the tests and ``chip_smoke.py`` hold the
kernels and their plain versions against these.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import strict_fp32
from repro_torch.kernels.streaming import im2col, pad_hw


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """fp32 product with an fp32 sum (TF32 off on the card), cast to ``out_dtype``."""
    strict_fp32()
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def matmul_ref64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The paper's common baseline: the product in fp64, on the operands' device."""
    return torch.matmul(a.double(), b.double())


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """NHWC x HWIO conv in fp32 (fp64 for fp64 operands), output in x's dtype.

    On the CPU through ``F.conv2d``; on the card through a plain im2col
    product, so that cuDNN is not the oracle of a kernel measured against it.
    """
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, wf = x.to(ct), w.to(ct)
    kh, kw, cin, cout = w.shape
    if x.device.type == "cpu":
        y = F.conv2d(xf.permute(0, 3, 1, 2), wf.permute(3, 2, 0, 1), stride=stride,
                     padding=padding).permute(0, 2, 3, 1)
    else:
        strict_fp32()
        n, h, wid, _ = x.shape
        oh = (h + 2 * padding - kh) // stride + 1
        ow = (wid + 2 * padding - kw) // stride + 1
        cols = im2col(pad_hw(xf, padding, padding), kh, kw, stride, oh, ow)
        y = torch.matmul(cols, wf.reshape(kh * kw * cin, cout)).reshape(n, oh, ow, cout)
    return y.to(x.dtype)


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
