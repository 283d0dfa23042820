"""Streaming matmul and its im2col conv wrapper (``repro/kernels/streaming.py``).

:func:`streaming_matmul` launches the hand-written Hopper kernel
``csrc/ntx_gemm_wgmma.cu`` on CUDA tensors (3xTF32 tile products on the
tensor cores, K tiles of the TPU kernel's ``_block(K)`` joined in order, the
K tiles split across CTAs where the output has few tiles; see
:mod:`repro_torch.kernels.gemm_wgmma`) and runs the plain version
:func:`streaming_matmul_torch` (``torch.matmul`` in fp32) on CPU tensors.
The kernel takes row and column strides, so the transposed views that the
dW and dX passes use need no copy. The earlier FFMA kernel
``csrc/streaming_mm.cu`` is reached only through :func:`launch` by name, to
time it beside the tensor-core kernel; no path of the port calls it.
:func:`streaming_conv2d` is im2col in torch plus this matmul;
:func:`streaming_tiles` is the pure-Python model of the TPU kernel's tile
stream, copied unchanged.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import gemm_wgmma as gemm
from repro_torch.kernels.ops import LaunchCounter, use_kernel

COUNTER = LaunchCounter("streaming_matmul")
FFMA = "streaming_mm_f32"
# C entry -> the library (csrc/<name>.cu) that exports it
ENTRIES = {gemm.ENTRY: gemm.LIB, FFMA: "streaming_mm"}


def streaming_matmul_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: C = A @ B in fp32."""
    COUNTER.plain_calls += 1
    return torch.matmul(a.float(), b.float())


def _ffma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, stream: int) -> int:
    fn = build.library(ENTRIES[FFMA]).streaming_mm_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), a.shape[0], b.shape[1], a.shape[1],
              a.stride(0), a.stride(1), b.stride(0), b.stride(1), stream)


def _shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"streaming_matmul: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")


def streaming_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] in fp32; A and B may be strided views."""
    _shapes(a, b)
    if not use_kernel(a, b):
        return streaming_matmul_torch(a, b)
    return launch(gemm.ENTRY, a, b)


def launch(name: str, a: torch.Tensor, b: torch.Tensor, *,
           split: int | None = None) -> torch.Tensor:
    """Launch C entry ``name`` on CUDA fp32 A, B; C (M, N) contiguous fp32.

    :func:`streaming_matmul` names the tensor-core entry, which is
    ``ntx_matmul``'s plain fp32 mode at K tiles of ``_block(K)``; a caller
    may name the FFMA entry to time it, or force the tensor-core entry's
    ``split``.
    """
    _shapes(a, b)
    if use_kernel(a, b) and (a.dtype != torch.float32 or b.dtype != torch.float32):
        raise TypeError(f"streaming_matmul kernel takes float32, got {a.dtype}, {b.dtype}")
    return gemm.launch_entry(name, COUNTER, (FFMA, ENTRIES[FFMA], _ffma), a, b,
                             block_k=_block(a.shape[1]), split=split)


def im2col(xp: torch.Tensor, kh: int, kw: int, stride: int, oh: int, ow: int) -> torch.Tensor:
    """(N, H, W, C) padded input -> (N*oh*ow, kh*kw*C) in (kh, kw, c) order."""
    s = stride
    cols = torch.cat(
        [
            xp[:, dh : dh + (oh - 1) * s + 1 : s, dw : dw + (ow - 1) * s + 1 : s, :]
            for dh in range(kh)
            for dw in range(kw)
        ],
        dim=-1,
    )
    return cols.reshape(xp.shape[0] * oh * ow, kh * kw * xp.shape[-1])


def pad_hw(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Zero-pad the H and W axes of an NHWC tensor."""
    if ph or pw:
        return F.pad(x, (0, 0, pw, pw, ph, ph))
    return x


def streaming_conv2d(
    x: torch.Tensor,  # (N, H, W, Cin)
    w: torch.Tensor,  # (KH, KW, Cin, Cout)
    *,
    stride: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """NHWC x HWIO conv as an im2col streaming matmul.

    The (kh, kw, cin) reduction dims flatten into the streamed K axis.
    """
    n, h, wid, cin = x.shape
    kh, kw, _, cout = w.shape
    x = pad_hw(x, padding, padding)
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (wid + 2 * padding - kw) // stride + 1
    lhs = im2col(x, kh, kw, stride, oh, ow)
    rhs = w.reshape(kh * kw * cin, cout)
    return streaming_matmul(lhs, rhs).reshape(n, oh, ow, cout)


def _block(dim: int, cap: int = 128) -> int:
    """The TPU kernel's block along a dimension: a power of two, at most ``cap``."""
    return min(cap, 1 << (dim - 1).bit_length()) if dim < cap else cap


def streaming_tiles(
    m: int, n: int, k: int,
    *,
    block_m: int | None = None,
    block_n: int | None = None,
    block_k: int | None = None,
    itemsize: int = 4,
) -> list[tuple[float, float]]:
    """The TPU kernel's tile stream as (dma_bytes, macs) pairs.

    One entry per (i, j, kk) inner step, in issue order: what the manual
    DMA engine of the TPU kernel transfers and contracts.
    """
    bm = block_m or _block(m)
    bn = block_n or _block(n)
    bk = block_k or _block(k)
    mp, np_, kp = -(-m // bm) * bm, -(-n // bn) * bn, -(-k // bk) * bk
    tiles = []
    for _i in range(mp // bm):
        for _j in range(np_ // bn):
            for _kk in range(kp // bk):
                tiles.append(((bm * bk + bk * bn) * itemsize, float(bm * bn * bk)))
    return tiles
