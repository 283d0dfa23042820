"""The tensor-core GEMM of K-tile partials: tiles, split over K, numerics.

``csrc/ntx_gemm_wgmma.cu`` (C entry :data:`ENTRY`) computes C[M, N] =
A[M, K] @ B[K, N] over K tiles of ``block_k`` in order, for fp32 or bf16
operands of one type read through any strides: each tile's product is
summed from zero in fp32, then joined to the accumulator (``acc += prod``,
or 2Sum into ``acc`` and ``comp``), and ``acc (+ comp)`` is rounded once to
the output type. The products run on ``wgmma``: bf16 operands as they are
(k16 slices), fp32 operands as 3xTF32 (k8 slices; each element split into
``hi = tf32_rn(x)`` and ``lo = tf32_rn(x - hi)``, and per slice lo·hi, hi·lo,
hi·hi). Each slice's products are summed from zero and added to the tile's
sum with one IEEE add. Where M x N gives too few tiles to fill the card, the
K tiles are dealt out across CTAs (the split): each tile's partial goes to a
workspace of k_tiles x M x N fp32 and a second pass joins them in tile
order, so the split changes no bit.

``ntx_matmul.tiled_matmul`` (B5) and ``streaming.streaming_matmul`` (B2)
launch it through :func:`launch_entry`, which also reaches each wrapper's
earlier FFMA entry by name and counts the launches per entry in the
wrapper's counter, the split's second pass under :data:`JOIN`. This module
holds what they and the tests need to know without a card: the tiles and
shared memory (:func:`smem_bytes`), the split (:func:`plan_split`,
:func:`k_ranges`, :func:`workspace_numel`), and the kernel's numerics in
plain PyTorch (:func:`emulate`, on any device).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.precision import two_sum
from repro_torch.kernels import build
from repro_torch.kernels.ops import LaunchCounter, strict_fp32, use_kernel

LIB = "ntx_gemm_wgmma"  # csrc/ntx_gemm_wgmma.cu
ENTRY = "ntx_gemm_wgmma"
JOIN = "ntx_gemm_wgmma.join"  # a counter's entry for the split's second kernel (join_kernel)
BM, BN = 128, 64  # rows and columns of C per CTA
CONSUMERS = 256  # threads of the two consumer warpgroups
STAGES = {torch.float32: 3, torch.bfloat16: 4}  # the ring of A / B stages
ROW = 128  # bytes of K of one tile row in a stage
SLICE = {torch.float32: 8, torch.bfloat16: 16}  # K elements per wgmma slice
PARTS = {torch.float32: 2, torch.bfloat16: 1}  # tiles per operand and stage (fp32: hi, lo)
SMS = 132  # streaming multiprocessors of an H100 SXM
WORKSPACE_CAP = 1 << 28  # bytes of split workspace a launch may allocate
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def smem_bytes(dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA: 1,024 bytes to align the swizzled
    tiles; ``STAGES`` stages of the A tile (``BM`` rows) and the B tile
    (``BN`` rows), 128 bytes a row and ``PARTS`` copies of each; and the
    fp32 accumulator and compensation of every consumer thread's 32 outputs."""
    return 1024 + STAGES[dtype] * PARTS[dtype] * (BM + BN) * ROW + 2 * 32 * CONSUMERS * 4


def k_tiles(k: int, block_k: int) -> int:
    return -(-k // block_k)


def tiles(m: int, n: int) -> int:
    """CTAs per part of the split: the BM x BN tiles of C."""
    return -(-m // BM) * -(-n // BN)


def k_ranges(n_k_tiles: int, split: int) -> list[tuple[int, int]]:
    """The K tiles [kt0, kt1) of each part of a split, as the kernel deals
    them out: contiguous ranges of ceil(k_tiles / split), no empty part."""
    per = _per_part(n_k_tiles, split)
    return [(kt, min(kt + per, n_k_tiles)) for kt in range(0, n_k_tiles, per)] or [(0, 0)]


def _per_part(n_k_tiles: int, split: int) -> int:
    return max(-(-n_k_tiles // split), 1)


def n_parts(n_k_tiles: int, split: int) -> int:
    """Parts (CTAs along K) of a split: len(k_ranges(n_k_tiles, split))."""
    return max(-(-n_k_tiles // _per_part(n_k_tiles, split)), 1)


def workspace_numel(m: int, n: int, k: int, block_k: int, split: int) -> int:
    """fp32 elements of the split's workspace: one M x N partial per K tile,
    none where the K tiles go to one part."""
    kt = k_tiles(k, block_k)
    return kt * m * n if n_parts(kt, split) > 1 else 0


def plan_split(m: int, n: int, k: int, block_k: int, sms: int = SMS) -> int:
    """The split a wrapper launches: 1 where the tiles of C fill at least half
    the card's SMs, else enough parts to give every SM a CTA (at most one per
    K tile), unless the workspace would pass :data:`WORKSPACE_CAP`."""
    t, kt = tiles(m, n), k_tiles(k, block_k)
    if kt <= 1 or t == 0 or 2 * t > sms:
        return 1
    split = min(kt, -(-sms // t))
    return split if workspace_numel(m, n, k, block_k, split) * 4 <= WORKSPACE_CAP else 1


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fn():
    fn = getattr(build.library(LIB), ENTRY)
    if fn.argtypes is None:  # a, b, c, ws, in, out, comp, M, N, K, bk, split, 4 strides
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch(a: torch.Tensor, b: torch.Tensor, *, block_k: int, out_dtype=torch.float32,
           compensated: bool = False, split: int | None = None,
           counter: LaunchCounter | None = None) -> torch.Tensor:
    """C = A @ B by the kernel on CUDA A (M, K) and B (K, N) of one type;
    C (M, N) contiguous in ``out_dtype``. ``split`` defaults to
    :func:`plan_split`'s. Raises on what the kernel does not take. With a
    ``counter``, counts the launch under :data:`ENTRY` and, where the split
    has more than one part, the second pass under :data:`JOIN`."""
    if a.dtype != b.dtype or a.dtype not in _TYPES:
        raise TypeError(f"{ENTRY} takes float32 or bfloat16 operands of one type, "
                        f"got {a.dtype}, {b.dtype}")
    if out_dtype not in _TYPES:
        raise TypeError(f"{ENTRY}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) > _INT_MAX or block_k < 1:
        raise ValueError(f"{ENTRY}: M, N, K {m}, {n}, {k} must be below 2**31 and block_k "
                         f"{block_k} positive")
    if split is None:
        split = plan_split(m, n, k, block_k, sm_count(a.device.index or 0))
    parts = n_parts(k_tiles(k, block_k), split) if split >= 1 else 0
    ws_numel = workspace_numel(m, n, k, block_k, split) if parts else 0
    if not 1 <= parts <= 65535 or ws_numel * 4 > WORKSPACE_CAP:
        raise ValueError(f"{ENTRY}: split {split} gives {parts} parts and "
                         f"{ws_numel * 4} bytes of workspace")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    ws = torch.empty(ws_numel, dtype=torch.float32, device=a.device) if ws_numel else None
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = _fn()(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), None if ws is None else ws.data_ptr(),
        _TYPES[a.dtype], _TYPES[out_dtype], int(compensated), m, n, k, block_k, split,
        a.stride(0), a.stride(1), b.stride(0), b.stride(1), stream,
    )
    build.check(LIB, code, ENTRY)
    if counter is not None:
        _count(counter, ENTRY)
        if ws is not None:  # the C entry launched join_kernel after the GEMM
            counter.entries[JOIN] = counter.entries.get(JOIN, 0) + 1
    return c


def _count(counter: LaunchCounter, entry: str) -> None:
    counter.launches += 1
    counter.entries[entry] = counter.entries.get(entry, 0) + 1


def launch_entry(name: str, counter: LaunchCounter, ffma: tuple, a: torch.Tensor,
                 b: torch.Tensor, *, block_k: int, out_dtype=torch.float32,
                 compensated: bool = False, split: int | None = None) -> torch.Tensor:
    """Launch C entry ``name`` on CUDA A, B for the wrapper that owns
    ``counter``: :data:`ENTRY` (:func:`launch`), or the wrapper's earlier FFMA
    entry ``ffma = (name, library, call)``, where ``call(a, b, c, stream)``
    returns the entry's error code; only :data:`ENTRY` takes a ``split``.
    Counts one launch under the entry's name (and :data:`JOIN`, as
    :func:`launch` does)."""
    if not use_kernel(a, b):
        raise ValueError(f"{counter.name}: {name} takes CUDA tensors; the wrapper runs the "
                         f"plain version on CPU tensors")
    ffma_name, ffma_lib, ffma_call = ffma
    if name == ENTRY:
        return launch(a, b, block_k=block_k, out_dtype=out_dtype, compensated=compensated,
                      split=split, counter=counter)
    if name != ffma_name or split is not None:
        raise ValueError(f"{counter.name}: no C entry {name!r} with split {split}; entries are "
                         f"{sorted((ENTRY, ffma_name))}, and only {ENTRY} splits")
    c = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype, device=a.device)
    build.check(ffma_lib, ffma_call(a, b, c, torch.cuda.current_stream(a.device).cuda_stream),
                name)
    _count(counter, name)
    return c


# ---- the numerics in plain PyTorch -------------------------------------------

def tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to nearest even at TF32's 10 mantissa bits, as the
    kernel's split rounds them; inf and nan kept."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    r = torch.where((u & 0x7F800000) == 0x7F800000, u, r)
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = tf32_rn(x), lo = tf32_rn(x - hi), lo 0 where hi is not finite."""
    hi = tf32_rn(x)
    lo = torch.where(torch.isfinite(hi), tf32_rn(x.float() - hi), torch.zeros_like(hi))
    return hi, lo


def emulate(a: torch.Tensor, b: torch.Tensor, *, block_k: int, out_dtype=torch.float32,
            compensated: bool = False, terms: int = 3, split: int = 1) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, with IEEE fp32 sums where
    the tensor cores use their own: per K tile and per slice of
    ``SLICE[a.dtype]`` (a tile's last slice padded with zeros, as the kernel's
    masks pad it), the
    slice's products summed from zero (fp32: lo·hi, then + hi·lo, then +
    hi·hi; ``terms=1`` keeps hi·hi alone, the 1xTF32 control), the slice's
    sum added to the tile's; tiles joined in order. ``split`` > 1 first forms
    every tile's partial, part by part (:func:`k_ranges`), then joins them in
    tile order, as the kernel's split does."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    strict_fp32()
    m, k = a.shape
    slice_k = SLICE[a.dtype]
    if a.dtype == torch.float32:
        (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
        pairs = [(ah, bh)] if terms == 1 else [(al, bh), (ah, bl), (ah, bh)]
    else:
        pairs = [(a.float(), b.float())]

    def tile(kt: int) -> torch.Tensor:
        prod = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
        k1 = min((kt + 1) * block_k, k)
        for s0 in range(kt * block_k, k1, slice_k):
            pad = slice_k - (min(s0 + slice_k, k1) - s0)  # the tile's last slice: zeros
            sl = None
            for x, y in pairs:
                p = torch.matmul(F.pad(x[:, s0:s0 + slice_k - pad], (0, pad)),
                                 F.pad(y[s0:s0 + slice_k - pad], (0, 0, 0, pad)))
                sl = p if sl is None else sl + p
            prod = prod + sl
        return prod

    n_kt = k_tiles(k, block_k)
    parts = [tile(kt) for lo, hi in k_ranges(n_kt, split) for kt in range(lo, hi)] \
        if split > 1 else None
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    comp = torch.zeros_like(acc)
    for kt in range(n_kt):
        prod = parts[kt] if parts is not None else tile(kt)
        if compensated:
            acc, e = two_sum(acc, prod)
            comp = comp + e
        else:
            acc = acc + prod
    return (acc + comp if compensated else acc).to(out_dtype)
