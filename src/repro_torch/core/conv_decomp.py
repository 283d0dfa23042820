"""Strided-conv backward decomposition (paper §3.2, Fig. 6).

Counterpart of ``repro/core/conv_decomp.py``. The input gradient of a
stride-s convolution is a sparse convolution; the paper decomposes it into
s*s dense convolutions, one per input-pixel phase class, each using the
filter taps congruent to that phase, and interleaves the partial results.

Layouts: NHWC activations, HWIO weights, as in the JAX package. The
reference convolutions here go through ``torch.nn.functional.conv2d``; the
torch executor injects :func:`repro_torch.kernels.streaming.streaming_conv2d`
as the per-phase correlation, so the backward pass runs on the same
streaming kernel as the forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Reference forward: stride-s 2-D convolution, NHWC x HWIO -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _dense_corr(dy: torch.Tensor, w_ab: torch.Tensor, pads: tuple[int, int]) -> torch.Tensor:
    """Default dense stride-1 "full" correlation for one phase."""
    y = F.conv2d(dy.permute(0, 3, 1, 2), w_ab.permute(3, 2, 0, 1), padding=pads)
    return y.permute(0, 2, 3, 1)


def conv2d_input_grad_decomposed(
    dy: torch.Tensor,
    w: torch.Tensor,
    stride: int,
    x_hw: tuple[int, int],
    padding: int = 0,
    conv_fn=_dense_corr,
) -> torch.Tensor:
    """d(loss)/d(x) of :func:`conv2d`, as s*s interleaved *dense* convolutions.

    For input pixel (i, j), only the filter taps u = (i + pad) (mod s) (resp.
    v for j) ever touch it. Grouping pixels by phase (a, b) gives, per phase,
    a dense stride-1 correlation of ``dy`` with the *flipped* tap subset
    w[a::s, b::s].

    ``conv_fn(dy, w_ab, (pad_h, pad_w))`` performs the per-phase dense
    correlation. The phase pieces are added into a zero tensor in place.
    """
    n, yh, yw, cout = dy.shape
    kh, kw, cin, _ = w.shape
    xh, xw = x_hw
    s = stride
    dx = dy.new_zeros((n, xh, xw, cin))

    for a in range(s):
        ta = len(range(a, kh, s))  # taps in this row-phase
        if ta == 0:
            continue
        for b in range(s):
            tb = len(range(b, kw, s))
            if tb == 0:
                continue
            # tap subset for this phase, spatially flipped, channels swapped
            # (cout becomes the contraction dim of the backward conv)
            w_ab = w[a::s, b::s].flip((0, 1)).permute(0, 1, 3, 2)  # (ta, tb, cout, cin)

            # dense stride-1 "full" correlation: out[m] = sum_t dy[m-t]*w_sub[t]
            out_full = conv_fn(dy, w_ab, (ta - 1, tb - 1))  # (n, yh+ta-1, yw+tb-1, cin)

            # input pixels of this phase: i = i0 + s*q
            i0 = (a - padding) % s
            j0 = (b - padding) % s
            na = len(range(i0, xh, s))
            nb = len(range(j0, xw, s))
            if na == 0 or nb == 0:
                continue
            ii0 = (i0 + padding - a) // s
            jj0 = (j0 + padding - b) // s

            # clip against the valid range of out_full
            fh, fw = out_full.shape[1], out_full.shape[2]
            lo_i, lo_j = max(ii0, 0), max(jj0, 0)
            hi_i, hi_j = min(ii0 + na, fh), min(jj0 + nb, fw)
            if hi_i <= lo_i or hi_j <= lo_j:
                continue
            piece = out_full[:, lo_i:hi_i, lo_j:hi_j, :]

            di0 = i0 + s * (lo_i - ii0)
            dj0 = j0 + s * (lo_j - jj0)
            dx[
                :,
                di0 : di0 + s * piece.shape[1] : s,
                dj0 : dj0 + s * piece.shape[2] : s,
                :,
            ] += piece
    return dx


def conv2d_weight_grad(
    x: torch.Tensor,
    dy: torch.Tensor,
    stride: int,
    k_hw: tuple[int, int],
    padding: int = 0,
) -> torch.Tensor:
    """d(loss)/d(w): a correlation of x with dy dilated by the stride.

    The batch becomes the contraction: x is viewed with channels as batch
    and batch as channels, dy as a filter bank dilated by ``stride``.
    """
    kh, kw = k_hw
    dw = F.conv2d(
        x.permute(3, 0, 1, 2),  # (cin, N, H, W): the batch is the channel dim
        dy.permute(3, 0, 1, 2),  # (cout, N, yh, yw)
        padding=padding,
        dilation=stride,
    )  # (cin, cout, kh', kw')
    return dw[:, :, :kh, :kw].permute(2, 3, 0, 1)
