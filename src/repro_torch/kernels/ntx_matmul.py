"""NTX wide-accumulator matmul (``repro/kernels/ntx_matmul.py``).

C[M, N] = A[M, K] @ B[K, N] over K tiles of ``bk``, in order: each tile's
product is summed in fp32, then added to the accumulator (``acc += prod``),
or with ``compensated=True`` joined to it by 2Sum (``acc, e = two_sum(acc,
prod); comp += e``), and ``acc + comp`` is rounded once to ``out_dtype``.
Where the sums round depends on ``bk``, so ``bk`` is part of the function.

:func:`tiled_matmul` launches the hand-written Hopper kernel
``csrc/ntx_gemm_wgmma.cu`` on CUDA tensors (tile products on the tensor
cores: bf16 operands as they are, fp32 as 3xTF32; tiles, split and numerics
in :mod:`repro_torch.kernels.gemm_wgmma`) and runs the plain version
:func:`ntx_matmul_torch` on CPU tensors. Both mask ragged edges in place of
padding: K tiles start at multiples of ``bk`` and the last may be short.
:func:`ntx_matmul` is the TPU kernel's own entry: ``block_k`` from
``plan_matmul_tiles`` and a K that tiles by it evenly. The earlier FFMA
kernel ``csrc/ntx_matmul.cu`` is reached only through :func:`launch` by
name, to time it beside the tensor-core kernel; no path of the port calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.precision import two_sum
from repro_torch.core.tiling import plan_matmul_tiles
from repro_torch.kernels import build
from repro_torch.kernels import gemm_wgmma as gemm
from repro_torch.kernels.ops import LaunchCounter, strict_fp32, use_kernel

COUNTER = LaunchCounter("ntx_matmul")
FFMA = "ntx_matmul_launch"
# C entry -> the library (csrc/<name>.cu) that exports it
ENTRIES = {gemm.ENTRY: gemm.LIB, FFMA: "ntx_matmul"}
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype, block_k: int) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"ntx_matmul: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if out_dtype not in _TYPES:
        raise TypeError(f"ntx_matmul: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if block_k < 1:
        raise ValueError(f"ntx_matmul: block_k must be positive, got {block_k}")


def ntx_matmul_torch(a: torch.Tensor, b: torch.Tensor, *, block_k: int,
                     out_dtype=torch.float32, compensated: bool = False) -> torch.Tensor:
    """Plain version: the same K tiles, each product by ``torch.matmul`` in
    fp32 (TF32 off), combined in order with :func:`two_sum` when compensated."""
    _check(a, b, out_dtype, block_k)
    COUNTER.plain_calls += 1
    strict_fp32()
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    comp = torch.zeros_like(acc)
    for k0 in range(0, k, block_k):
        prod = torch.matmul(a[:, k0:k0 + block_k].float(), b[k0:k0 + block_k].float())
        if compensated:
            acc, e = two_sum(acc, prod)
            comp = comp + e
        else:
            acc = acc + prod
    return (acc + comp if compensated else acc).to(out_dtype)


def _ffma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, stream: int, *, block_k: int,
          compensated: bool) -> int:
    fn = build.library(ENTRIES[FFMA]).ntx_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), _TYPES[a.dtype], _TYPES[c.dtype],
              int(compensated), a.shape[0], b.shape[1], a.shape[1], block_k,
              a.stride(0), a.stride(1), b.stride(0), b.stride(1), stream)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *, block_k: int, out_dtype=torch.float32,
                 compensated: bool = False) -> torch.Tensor:
    """C = A @ B over K tiles of ``block_k``: the kernel for CUDA tensors, the
    plain version for CPU tensors. Any M, N, K; A and B may be strided views."""
    _check(a, b, out_dtype, block_k)
    if not use_kernel(a, b):
        return ntx_matmul_torch(a, b, block_k=block_k, out_dtype=out_dtype,
                                compensated=compensated)
    return launch(gemm.ENTRY, a, b, block_k=block_k, out_dtype=out_dtype,
                  compensated=compensated)


def launch(name: str, a: torch.Tensor, b: torch.Tensor, *, block_k: int,
           out_dtype=torch.float32, compensated: bool = False,
           split: int | None = None) -> torch.Tensor:
    """Launch C entry ``name`` on CUDA A, B of one type; C (M, N) contiguous.

    :func:`tiled_matmul` names the tensor-core entry; a caller may name the
    FFMA entry to time it, or force the tensor-core entry's ``split``.
    """
    _check(a, b, out_dtype, block_k)
    if use_kernel(a, b) and (a.dtype != b.dtype or a.dtype not in _TYPES):
        raise TypeError(f"ntx_matmul kernel takes float32 or bfloat16 operands of one type, "
                        f"got {a.dtype}, {b.dtype}")
    ffma = functools.partial(_ffma, block_k=block_k, compensated=compensated)
    return gemm.launch_entry(name, COUNTER, (FFMA, ENTRIES[FFMA], ffma), a, b, block_k=block_k,
                             out_dtype=out_dtype, compensated=compensated, split=split)


def ntx_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=torch.float32,
               compensated: bool = False, block_k: int | None = None) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] with NTX wide accumulation (the TPU kernel's entry).

    ``block_k`` defaults to :func:`plan_matmul_tiles`'s, and K must tile by
    it evenly, as on the TPU (``ops.matmul`` takes any K). The TPU grid's
    output blocks set no result, so the kernel's CTA tile is its own.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"ntx_matmul: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    plan = plan_matmul_tiles(m, n, k, in_dtype_bytes=max(a.element_size(), b.element_size()))
    bk = block_k or min(plan.bk, k)
    if k % bk:
        raise ValueError(f"K {k} must tile by block_k {bk}; use ops.matmul for other shapes")
    return tiled_matmul(a, b, block_k=bk, out_dtype=out_dtype, compensated=compensated)
