"""Mamba-2 SSD chunked scan (``repro/kernels/ssd_scan.py``).

:func:`ssd_scan` launches a hand-written Hopper kernel on CUDA tensors and
runs the plain version :func:`ssd_scan_torch` on CPU tensors; anything else
raises. :func:`entry` picks the kernel from the dtype and the shape: bf16
at the shapes :func:`repro_torch.kernels.ssd_scan_wgmma.takes` accepts (the
Mamba-2 780M's P 64, N 128, chunk 128 among them) goes to the tensor-core
kernel ``csrc/ssd_scan_wgmma.cu`` (the chunks in parallel, ``wgmma``
products, each fp32 operand of a product as two bf16 terms), fp32 at the
shapes :func:`repro_torch.kernels.ssd_scan_tf32.takes` accepts (the same)
to the tensor-core kernel ``csrc/ssd_scan_tf32.cu`` (the same four passes,
every product in 3xTF32), and other shapes of either dtype to the FFMA
kernel ``csrc/ssd_scan.cu``. There is no fallback from one to another. The plain version is the
chunked dual form of ``repro/kernels/ops.py::_ssd_chunked_xla`` in torch:
per chunk of length Q with inclusive cumsum ``cum`` of ``la``,

    y_intra[i] = sum_{j<=i} exp(cum_i - cum_j) (c_i . b_j) x_j
    y_inter[i] = exp(cum_i) (h c_i)
    h          = exp(cum_{Q-1}) h + sum_j exp(cum_{Q-1} - cum_j) x_j b_j^T

with the (P, N) state in fp32. b and c are shared by the ``H // G`` heads
of a group. The kernels read their inputs through their strides, so the
transposed views that ``ssm_block`` builds need no copy.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan_tf32 as tf32
from repro_torch.kernels import ssd_scan_wgmma as wgmma
from repro_torch.kernels.ops import LaunchCounter, use_kernel

COUNTER = LaunchCounter("ssd_scan")
_LIB = "ssd_scan"
FFMA = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
# C entry -> the library (csrc/<name>.cu) that exports it
ENTRIES = {**{name: _LIB for name in FFMA.values()}, wgmma.ENTRY: wgmma.LIB,
           tf32.ENTRY: tf32.LIB}
_ROWS = 32  # score rows the kernel holds at once (ROWS in ssd_scan.cu)
MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper


def _check(x, la, b, c, chunk):
    if x.dim() != 4 or la.dim() != 3 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"ssd_scan: bad ranks {tuple(x.shape)}, {tuple(la.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bb, h, s, _ = x.shape
    if la.shape != (bb, h, s) or b.shape[0] != bb or b.shape[2] != s:
        raise ValueError(f"ssd_scan: shapes disagree {tuple(x.shape)}, {tuple(la.shape)}, "
                         f"{tuple(b.shape)}")
    g = b.shape[1]
    if h % g:
        raise ValueError(f"ssd_scan: {h} heads are not a multiple of {g} groups")
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_scan: sequence {s} is not a multiple of chunk {chunk}")
    return chunk


def ssd_scan_torch(x, la, b, c, *, chunk: int = 128) -> torch.Tensor:
    """Plain version: the chunked dual form, fp32 inside, y in x's dtype."""
    COUNTER.plain_calls += 1
    chunk = _check(x, la, b, c, chunk)
    bb, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    grp, nc = h // g, s // chunk
    xf = x.float().reshape(bb, g, grp, nc, chunk, p)
    laf = la.float().reshape(bb, g, grp, nc, chunk)
    bf = b.float().reshape(bb, g, nc, chunk, n)
    cf = c.float().reshape(bb, g, nc, chunk, n)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((bb, g, grp, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for ci in range(nc):
        xc, bc, cc = xf[:, :, :, ci], bf[:, :, None, ci], cf[:, :, None, ci]
        cum = torch.cumsum(laf[:, :, :, ci], dim=-1)  # (B, G, grp, Q) inclusive
        total = cum[..., -1:]
        scores = cc @ bc.transpose(-1, -2)  # (B, G, 1, Q, Q)
        # select, never multiply: exp above the diagonal may be inf
        decay = torch.where(causal, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
        y = (scores * decay) @ xc  # (B, G, grp, Q, P)
        y = y + torch.exp(cum)[..., None] * (cc @ state.transpose(-1, -2))
        w = torch.exp(total - cum)[..., None] * bc  # (B, G, grp, Q, N)
        state = torch.exp(total)[..., None] * state + xc.transpose(-1, -2) @ w
        ys.append(y)
    return torch.stack(ys, dim=3).reshape(bb, h, s, p).to(x.dtype)


def smem_bytes(p: int, n: int, q: int) -> int:
    """Dynamic shared memory of one FFMA kernel block (the layout in ssd_scan.cu)."""
    rows = min(_ROWS, q)
    return 4 * (q * p + 2 * q * (n + 1) + p * (n + 1) + 2 * q + rows * q)


def entry(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """The C entry a CUDA call launches, from x's dtype, P, N and the chunk
    (after it is clamped to S).

    bf16 where :func:`repro_torch.kernels.ssd_scan_wgmma.takes` accepts the
    shape -> ``ssd_scan_bf16_wgmma``; fp32 where
    :func:`repro_torch.kernels.ssd_scan_tf32.takes` accepts it ->
    ``ssd_scan_f32_tf32`` (both on the tensor cores); other fp32 ->
    ``ssd_scan_f32`` and other bf16 -> ``ssd_scan_bf16`` (FFMA). Other dtypes
    raise ``TypeError``.
    """
    if dtype not in FFMA:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 x/b/c, got {dtype}")
    if wgmma.takes(dtype, p, n, chunk):
        return wgmma.ENTRY
    return tf32.ENTRY if tf32.takes(dtype, p, n, chunk) else FFMA[dtype]


def _fn(name: str):
    fn = getattr(build.library(ENTRIES[name]), name)
    if fn.argtypes is None:
        # x, la, b, c, y, (ws,) dims, stream
        fn.argtypes = [ctypes.c_void_p] * (8 if name in (wgmma.ENTRY, tf32.ENTRY) else 7)
        fn.restype = ctypes.c_int
    return fn


def launch(name: str, x: torch.Tensor, la: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
           chunk: int = 128) -> torch.Tensor:
    """Launch C entry ``name`` on CUDA operands; y (B, H, S, P) in x's dtype.

    :func:`ssd_scan` calls it with :func:`entry`'s choice; a caller may name
    an FFMA entry for operands a tensor-core entry takes (to time it). The
    tensor-core entries check their rules on x, b and c
    (:func:`repro_torch.kernels.ssd_scan_wgmma.tma_strides`,
    :func:`repro_torch.kernels.ssd_scan_tf32.operand_strides`) and allocate
    their workspace. Counts one launch, under the entry's name.
    """
    if not use_kernel(x, la, b, c):
        raise ValueError(f"ssd_scan: {name} takes CUDA tensors; ssd_scan runs the plain "
                         f"version on CPU tensors")
    chunk = _check(x, la, b, c, chunk)
    if x.dtype not in FFMA or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 x/b/c of one dtype, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if la.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel takes float32 la, got {la.dtype}")
    bb, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    ws = None
    if name == wgmma.ENTRY:
        if not wgmma.takes(x.dtype, p, n, chunk):
            raise ValueError(f"{name} takes bf16 with P and N multiples of {wgmma.BOX}, N at "
                             f"most {wgmma.MAX_N} and chunks of {wgmma.CHUNKS}, got {x.dtype}, "
                             f"P {p}, N {n}, chunk {chunk}")
        strides = [wgmma.tma_strides(t, nm) for t, nm in ((x, "x"), (b, "b"), (c, "c"))]
        ws = torch.empty(wgmma.workspace_bytes(bb, h, g, s, p, n, chunk) // 4,
                         dtype=torch.float32, device=x.device)
    elif name == tf32.ENTRY:
        if not tf32.takes(x.dtype, p, n, chunk):
            raise ValueError(f"{name} takes fp32 with P and N multiples of {tf32.TILE}, N at "
                             f"most {tf32.MAX_N} and chunks of {tf32.CHUNKS}, got {x.dtype}, "
                             f"P {p}, N {n}, chunk {chunk}")
        strides = [tf32.operand_strides(t, nm) for t, nm in ((x, "x"), (b, "b"), (c, "c"))]
        ws = torch.empty(tf32.workspace_bytes(bb, h, g, s, p, n, chunk) // 4,
                         dtype=torch.float32, device=x.device)
    elif name == FFMA.get(x.dtype):
        need = smem_bytes(p, n, chunk)
        if need > MAX_SMEM:
            raise ValueError(f"{name}: P={p}, N={n}, chunk={chunk} need {need} bytes of "
                             f"shared memory, more than {MAX_SMEM}")
        strides = [x.stride(), b.stride(), c.stride()]
    else:
        raise ValueError(f"ssd_scan: no C entry {name!r} for {x.dtype}; entries are "
                         f"{sorted(ENTRIES)}")
    y = torch.empty((bb, h, s, p), dtype=x.dtype, device=x.device)
    dims = (ctypes.c_longlong * 22)(bb, h, g, s, p, n, chunk, *strides[0], *la.stride(),
                                    *strides[1], *strides[2])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = [x.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr()]
    if ws is not None:
        args.append(ws.data_ptr())
    code = _fn(name)(*args, ctypes.addressof(dims), stream)
    build.check(ENTRIES[name], code, name)
    COUNTER.launches += 1
    COUNTER.entries[name] = COUNTER.entries.get(name, 0) + 1
    return y


def ssd_scan(
    x: torch.Tensor,  # (B, H, S, P)
    la: torch.Tensor,  # (B, H, S) log decay (<= 0), fp32
    b: torch.Tensor,  # (B, G, S, N)
    c: torch.Tensor,  # (B, G, S, N)
    *,
    chunk: int = 128,
) -> torch.Tensor:
    """Chunked SSD scan; returns y with shape (B, H, S, P) in x's dtype."""
    if not use_kernel(x, la, b, c):
        return ssd_scan_torch(x, la, b, c, chunk=chunk)
    q = _check(x, la, b, c, chunk)
    return launch(entry(x.dtype, x.shape[3], b.shape[3], q), x, la, b, c, chunk=chunk)
