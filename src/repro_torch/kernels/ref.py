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


def conv_rounded_once_share(y: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                            stride: int = 1) -> float:
    """The share of the elements of ``y`` that differ from the fp64 conv of
    the same x and w (:func:`conv2d_ref` in fp64) rounded once to y's dtype.

    The fp64 result reaches bf16 through fp32, as in
    :func:`rounded_once_share`. For bf16 a conv that sums in fp32 and rounds
    once differs in a few elements in ten thousand (fp32 sums near a
    rounding boundary); one that rounds its sum to bf16 after every tap moves
    about half of them.
    """
    want = conv2d_ref(x.double(), w.double(), stride=stride).float().to(y.dtype)
    return float((y != want).double().mean())


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Dense softmax attention in fp32 (or ``compute_dtype``), GQA by
    repeating k and v; o rounded once to q's dtype.

    Rows with no visible key give 0, as the flash kernel does. The decode
    offsets of the JAX oracle come with the decode slice.
    """
    hq, sq, d = q.shape[1:]
    skv = k.shape[2]
    grp = hq // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / d**0.5
    kf = k.to(compute_dtype).repeat_interleave(grp, dim=1)
    vf = v.to(compute_dtype).repeat_interleave(grp, dim=1)
    s = (q.to(compute_dtype) @ kf.transpose(-1, -2)) * sm_scale
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


def rounded_once_share(o: torch.Tensor, q, k, v, **kw) -> float:
    """The share of the elements of ``o`` that differ from the fp64 dense
    attention of the same q, k, v rounded once to o's dtype.

    For bf16 an attention that keeps p in fp32 differs in a few elements in
    ten thousand (sums in fp32 that land near a rounding boundary); one
    that rounds p to bf16 before ``p v`` moves about two in five. The fp64
    result reaches bf16 through fp32 (PyTorch's cast), a double rounding
    that can move about 2**-16 of the elements.
    """
    want = attention_ref(q, k, v, compute_dtype=torch.float64, **kw).to(o.dtype)
    return float((o != want).double().mean())


def ssd_ref(
    x: torch.Tensor,  # (B, H, S, P)
    la: torch.Tensor,  # (B, H, S)
    b: torch.Tensor,  # (B, G, S, N)
    c: torch.Tensor,  # (B, G, S, N)
    h0: torch.Tensor | None = None,  # (B, H, P, N)
    *,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Sequential SSD recurrence (the literal state-space model) in fp32 (or
    ``compute_dtype``).

    h_t = exp(la_t) h_{t-1} + x_t b_t^T,  y_t = h_t c_t; y in x's dtype.
    """
    bb, h, s, p = x.shape
    n = b.shape[-1]
    grp = h // b.shape[1]
    bf = b.to(compute_dtype).repeat_interleave(grp, dim=1)  # (B, H, S, N)
    cf = c.to(compute_dtype).repeat_interleave(grp, dim=1)
    xf, laf = x.to(compute_dtype), la.to(compute_dtype)
    state = (h0.to(compute_dtype) if h0 is not None
             else x.new_zeros((bb, h, p, n), dtype=compute_dtype))
    ys = []
    for t in range(s):
        a = torch.exp(laf[:, :, t])[..., None, None]
        state = a * state + xf[:, :, t, :, None] * bf[:, :, t, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, :, t]))
    return torch.stack(ys, dim=2).to(x.dtype)


def ssd_rounded_once_share(y: torch.Tensor, x, la, b, c) -> float:
    """The share of the elements of ``y`` that differ from the fp64 SSD of the
    same x, la, b, c (:func:`ssd_ref` in fp64) rounded once to y's dtype.

    For bf16 a scan that keeps every operand of its products in fp32 differs
    in a few elements in ten thousand; one that enters each fp32 operand of
    a bf16 product as two bf16 terms in about two in a thousand, as one
    term in about two in five (tests/test_torch_ssd_wgmma.py).
    """
    want = ssd_ref(x, la, b, c, compute_dtype=torch.float64).to(y.dtype)
    return float((y != want).double().mean())
