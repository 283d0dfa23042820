"""The tensor-core conv2d_ntx kernel for fp32: tiles, operand rules, numerics.

``csrc/conv2d_ntx_tf32.cu`` (C entry :data:`ENTRY`) computes what
``csrc/conv2d_ntx.cu`` computes, for fp32 x and w whose Cin is a multiple
of :data:`CIN_STEP` and Cout a multiple of :data:`COUT_STEP`, as an
implicit GEMM on ``wgmma`` in 3xTF32: M = the output pixels, N = Cout,
K = kh*kw*Cin walked in the order (u, v, ci) in stages of 32 channels of
one tap: each k8 slice's products lo·hi, hi·lo, hi·hi (``hi = tf32_rn(x)``,
``lo = tf32_rn(x - hi)``) summed from zero on the tensor cores, the four
slices of a stage summed from zero by IEEE adds, and the stage's sum added
to the pixel's fp32 sum by one more; y stored once. The C entry first
writes w's split, transposed to K-major (Cout, K) hi and lo matrices, into
a workspace the wrapper allocates (:func:`workspace_numel`), then runs the
conv: two kernels a call, the first counted under :data:`SPLIT`.
:func:`repro_torch.kernels.conv2d.conv2d_ntx` launches it; this module
holds what the wrapper and the tests need to know about it without a card:
which shapes it takes (:func:`takes`), its tiles and shared memory
(:func:`block_n`, :func:`smem_bytes`, :func:`workspace_numel`), its rules
on the operands (:func:`x_strides`), which the wrapper checks before a
launch and raises on (the kernel copies nothing of x), and its arithmetic
in plain PyTorch (:func:`emulate`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gemm_wgmma import split_tf32
from repro_torch.kernels.ops import strict_fp32

LIB = "conv2d_ntx_tf32"  # csrc/conv2d_ntx_tf32.cu
ENTRY = "conv2d_ntx_f32_tf32"
SPLIT = "conv2d_ntx_tf32.split_w"  # a counter's entry for the call's first kernel (split_w_kernel)
CIN_STEP = 32  # input channels per stage: one 128-byte row of fp32 per pixel
COUT_STEP = 64  # Cout must be a multiple of it
BM = 128  # output pixels per CTA (two consumer warpgroups)
SLICE = 8  # K elements of one tf32 wgmma


def takes(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """Whether the kernel computes this conv: fp32 with Cin a multiple of 32
    and Cout a multiple of 64 (GoogLeNet L1-L3; not L0's Cin 3)."""
    return dtype == torch.float32 and cin % CIN_STEP == 0 and cout % COUT_STEP == 0


STAGES = 4  # the ring of A / B stages


def block_n(cout: int) -> int:
    """Cout columns per CTA: 96 where they divide Cout (GoogLeNet L1, L3), else
    64. A thread keeps three fp32 arrays of a tile's width (the pixel's sum,
    the stage's sum, the slice), so 192 would not fit its registers."""
    return 96 if cout % 96 == 0 else 64


def smem_bytes(cout: int) -> int:
    """Shared memory of one block: per stage the A tile (one 128-byte row
    per pixel, its hi written over the gathered x, and its lo) and the B
    tile's hi and lo (``block_n`` rows of 128 bytes); 1,024 bytes to align
    the swizzled tiles; the 8-byte full and empty mbarriers per stage."""
    stage = 2 * BM * 128 + 2 * block_n(cout) * 128
    return 1024 + STAGES * stage + 8 * 2 * STAGES


def workspace_numel(kh: int, kw: int, cin: int, cout: int) -> int:
    """fp32 elements of w's split, K-major: hi and lo, each Cout x kh*kw*Cin."""
    return 2 * kh * kw * cin * cout


def x_strides(x: torch.Tensor) -> tuple[int, int, int]:
    """x's (n, h, w) element strides, after checking the kernel's rules.

    The gather copies 16 bytes at a time, so x needs a unit channel stride,
    pixel strides that are multiples of 16 bytes and a 16-byte-aligned base;
    anything else raises ``ValueError`` (the kernel does not copy).
    """
    size = x.element_size()
    strides = tuple(x.stride())
    if strides[3] != 1 or x.data_ptr() % 16 or any(st * size % 16 for st in strides[:3]):
        raise ValueError(
            f"conv2d_ntx fp32 tf32 kernel: x needs a unit channel stride, a 16-byte-aligned "
            f"base and pixel strides that are multiples of 16 bytes, got strides {strides}, "
            f"base {x.data_ptr() % 16} bytes past 16")
    return strides[:3]


def emulate(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
            terms: int = 3) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, with IEEE fp32 sums where the
    tensor cores use their own: per tap (u, v) in order and per stage of
    :data:`CIN_STEP` input channels, each k8 slice's products summed from
    zero (lo·hi, then + hi·lo, then + hi·hi; ``terms=1`` keeps hi·hi alone,
    the 1xTF32 control), the stage's slices summed from zero, and the
    stage's sum added to the pixel's fp32 sum. fp32 x (N, H, W, Cin), w
    (kh, kw, Cin, Cout) -> fp32 y (N, OH, OW, Cout)."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    strict_fp32()
    kh, kw, cin, cout = w.shape
    n, h, wid, _ = x.shape
    oh, ow = (h - kh) // stride + 1, (wid - kw) // stride + 1
    (xh, xl), (wh, wl) = split_tf32(x.float()), split_tf32(w.float())
    acc = torch.zeros((n, oh, ow, cout), dtype=torch.float32, device=x.device)
    for u in range(kh):
        for v in range(kw):
            rows = slice(u, u + (oh - 1) * stride + 1, stride)
            cols = slice(v, v + (ow - 1) * stride + 1, stride)
            ah, al = xh[:, rows, cols], xl[:, rows, cols]
            for c0 in range(0, cin, CIN_STEP):
                part = None
                for c1 in range(c0, min(c0 + CIN_STEP, cin), SLICE):
                    cs = slice(c1, c1 + SLICE)
                    if terms == 1:
                        sl = ah[..., cs] @ wh[u, v, cs]
                    else:
                        sl = al[..., cs] @ wh[u, v, cs]
                        sl = sl + ah[..., cs] @ wl[u, v, cs]
                        sl = sl + ah[..., cs] @ wh[u, v, cs]
                    part = sl if part is None else part + sl
                acc = acc + part
    return acc
