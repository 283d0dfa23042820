"""The tensor-core conv2d_ntx kernel for a few-channel stem: rules, tiles, numerics.

``csrc/conv2d_ntx_stem.cu`` (C entry :data:`ENTRY`) computes what
``csrc/conv2d_ntx.cu`` computes, for fp32 or bf16 x and w whose channel
counts neither wide tensor-core kernel takes (GoogLeNet L0's Cin 3), with
K = kh*kw*Cin at most :data:`MAX_K` and Cout a multiple of :data:`COUT_STEP`,
as an implicit GEMM on ``wgmma``: M = the output pixels in tiles of 8 x 16
of one image, N = Cout, K = (u, v, ci) flattened and padded with zeros to
whole slices. Each CTA holds its tile's slab of x in shared memory (split
into tf32 hi and lo once in fp32) and reads every thread's A fragment from
it into registers; w's 64 columns sit K-major in shared memory. bf16: the
slices summed in the fp32 accumulator, y rounded once. fp32 (3xTF32): per
k8 slice lo·hi, hi·lo, hi·hi summed from zero, the slices of a stage of 32 K
summed from zero by IEEE adds, the stage's sum added to the pixel's.

:func:`repro_torch.kernels.conv2d.conv2d_ntx` launches it; this module holds
what the wrapper and the tests need to know about it without a card: which
shapes it takes (:func:`takes`), its shared memory (:func:`smem_bytes`) and
its arithmetic in plain PyTorch (:func:`emulate`). x is read through any
strides, so there is no operand rule beyond the shapes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import conv2d_ntx_tf32 as tf32
from repro_torch.kernels import conv2d_ntx_wgmma as wgmma
from repro_torch.kernels.gemm_wgmma import split_tf32
from repro_torch.kernels.ops import strict_fp32

LIB = "conv2d_ntx_stem"  # csrc/conv2d_ntx_stem.cu
ENTRY = "conv2d_ntx_stem"
MAX_K = 256  # kh*kw*Cin the kernel takes
COUT_STEP = 64  # Cout columns per CTA
TILE = (8, 16)  # output rows and columns of a pixel tile
SLICE = {torch.float32: 8, torch.bfloat16: 16}  # K elements of one wgmma
BOX = {torch.float32: 32, torch.bfloat16: 64}  # K elements of one 128-byte row of w
PARTS = {torch.float32: 2, torch.bfloat16: 1}  # fp32 keeps hi and lo of w and of the slab
MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper


def smem_bytes(dtype: torch.dtype, kh: int, kw: int, cin: int, stride: int) -> int:
    """Dynamic shared memory of one block: 1,024 bytes to align the swizzled
    tiles, w's 64 columns K-major (one 8 KB box of 64 rows x 128 bytes per
    128 bytes of K, hi and lo in fp32), the slab offset of each K index (an
    int32 a K of whole slices) and the pixel tile's slab of x (hi and lo in
    fp32), as ``smem_of`` in the source computes it."""
    k = kh * kw * cin
    kpad = -(-k // SLICE[dtype]) * SLICE[dtype]
    boxes = -(-kpad // BOX[dtype])
    rows, cols = (TILE[0] - 1) * stride + kh, (TILE[1] - 1) * stride + kw
    slab = rows * cols * cin * (4 if dtype == torch.float32 else 2)
    return 1024 + PARTS[dtype] * (boxes * 64 * 128 + slab) + 4 * kpad


def takes(dtype: torch.dtype, kh: int, kw: int, cin: int, cout: int, stride: int = 1) -> bool:
    """Whether the kernel computes this conv: fp32 or bf16 whose channel
    counts neither wide kernel takes (:mod:`conv2d_ntx_wgmma` for bf16,
    :mod:`conv2d_ntx_tf32` for fp32), K = kh*kw*Cin at most :data:`MAX_K`,
    Cout a multiple of 64, and a slab that fits one block at this stride
    (GoogLeNet L0: 7 x 7 x 3, stride 2 -> 64)."""
    if dtype not in SLICE or wgmma.takes(dtype, cin, cout) or tf32.takes(dtype, cin, cout):
        return False
    return (0 < kh * kw * cin <= MAX_K and cout > 0 and cout % COUT_STEP == 0 and stride >= 1
            and smem_bytes(dtype, kh, kw, cin, stride) <= MAX_SMEM)


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """(N, OH, OW, kh*kw*Cin): each pixel's taps in the order (u, v, ci)."""
    _, h, w, _ = x.shape
    oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
    return torch.cat([x[:, u:u + (oh - 1) * stride + 1:stride, v:v + (ow - 1) * stride + 1:stride]
                      for u in range(kh) for v in range(kw)], dim=-1)


def emulate(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
            terms: int = 3) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, with IEEE fp32 sums where the
    tensor cores use their own. K = (u, v, ci) padded with zeros to whole
    slices. fp32: each k8 slice's products summed from zero (lo·hi, then +
    hi·lo, then + hi·hi; ``terms=1`` keeps hi·hi alone, the 1xTF32 control),
    the slices of a stage of 32 K summed from zero, the stage added to the
    pixel's fp32 sum; y in fp32. bf16: the k16 slices' exact products summed
    into one fp32 sum in order, y rounded once to bf16. x (N, H, W, Cin), w
    (kh, kw, Cin, Cout) of one dtype."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    strict_fp32()
    kh, kw, cin, cout = w.shape
    a = _im2col(x.float(), kh, kw, stride)
    b = w.float().reshape(kh * kw * cin, cout)
    k, step = b.shape[0], SLICE[x.dtype]
    kpad = -(-k // step) * step
    a, b = F.pad(a, (0, kpad - k)), F.pad(b, (0, 0, 0, kpad - k))
    if x.dtype == torch.bfloat16:
        acc = torch.zeros((*a.shape[:-1], cout), dtype=torch.float32, device=x.device)
        for k0 in range(0, kpad, step):
            acc = acc + a[..., k0:k0 + step] @ b[k0:k0 + step]
        return acc.bfloat16()
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    pairs = [(ah, bh)] if terms == 1 else [(al, bh), (ah, bl), (ah, bh)]
    acc = torch.zeros((*a.shape[:-1], cout), dtype=torch.float32, device=x.device)
    for k0 in range(0, kpad, BOX[x.dtype]):
        part = None
        for k1 in range(k0, min(k0 + BOX[x.dtype], kpad), step):
            cs = slice(k1, k1 + step)
            sl = None
            for p, q in pairs:
                t = p[..., cs] @ q[cs]
                sl = t if sl is None else sl + t
            part = sl if part is None else part + sl
        acc = acc + part
    return acc
