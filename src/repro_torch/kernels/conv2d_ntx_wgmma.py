"""The tensor-core conv2d_ntx kernel for bf16: tiles and operand rules.

``csrc/conv2d_ntx_wgmma.cu`` (C entry :data:`ENTRY`) computes what
``csrc/conv2d_ntx.cu`` computes, for bf16 x and w whose Cin and Cout are
multiples of :data:`CHANNELS`, as an implicit GEMM on ``wgmma``: M = the
output pixels, N = Cout, K = kh*kw*Cin walked in the order (u, v, ci), fp32
sums, y rounded once to bf16. :func:`repro_torch.kernels.conv2d.conv2d_ntx`
launches it; this module holds what the wrapper and the tests need to know
about it without a card: which shapes it takes (:func:`takes`), its tiles
and shared memory (:func:`smem_bytes`), and its rules on the operands
(:func:`x_strides`), which the wrapper checks before a launch and raises on:
the kernel copies nothing.
"""

from __future__ import annotations

import torch

LIB = "conv2d_ntx_wgmma"  # csrc/conv2d_ntx_wgmma.cu
ENTRY = "conv2d_ntx_bf16_wgmma"
CHANNELS = 64  # Cin and Cout must be multiples of it
BM, BK = 128, 64  # output pixels per CTA (two warpgroups), input channels per stage
STAGES = 4  # the ring of A / B stages


def takes(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """Whether the kernel computes this conv: bf16 with Cin and Cout multiples of 64."""
    return dtype == torch.bfloat16 and cin % CHANNELS == 0 and cout % CHANNELS == 0


def block_n(cout: int) -> int:
    """Cout columns per CTA: 192 where they divide Cout (GoogLeNet L1, L3), else 64."""
    return 192 if cout % 192 == 0 else 64


def smem_bytes(cout: int) -> int:
    """Shared memory of one block: ``STAGES`` A tiles (one 128-byte row per
    pixel) and B tiles (64 rows of ``block_n`` bf16), 1,024 bytes to align
    the swizzled tiles, and the 8-byte full and empty mbarriers per stage."""
    tiles = STAGES * (BM * BK * 2 + BK * block_n(cout) * 2)
    return 1024 + tiles + 8 * 2 * STAGES


def x_strides(x: torch.Tensor, w: torch.Tensor) -> tuple[int, int, int]:
    """x's (n, h, w) element strides, after checking the kernel's rules.

    The gather copies 16 bytes at a time and w loads by TMA, so x needs a
    unit channel stride, pixel strides that are multiples of 16 bytes and a
    16-byte-aligned base, and w (contiguous) a 16-byte-aligned base; anything
    else raises ``ValueError`` (the kernel does not copy).
    """
    size = x.element_size()
    strides = tuple(x.stride())
    if strides[3] != 1 or x.data_ptr() % 16 or any(st * size % 16 for st in strides[:3]):
        raise ValueError(
            f"conv2d_ntx bf16 wgmma kernel: x needs a unit channel stride, a 16-byte-aligned "
            f"base and pixel strides that are multiples of 16 bytes, got strides {strides}, "
            f"base {x.data_ptr() % 16} bytes past 16")
    if w.data_ptr() % 16:
        raise ValueError(f"conv2d_ntx bf16 wgmma kernel: w needs a 16-byte-aligned base (TMA), "
                         f"got {w.data_ptr() % 16} bytes past 16")
    return strides[:3]
