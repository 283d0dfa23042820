"""Mamba-2 SSD chunked scan (``repro/kernels/ssd_scan.py``).

:func:`ssd_scan` launches the hand-written Hopper kernel
``csrc/ssd_scan.cu`` on CUDA tensors and runs the plain version
:func:`ssd_scan_torch` on CPU tensors; anything else raises. The plain
version is the chunked dual form of ``repro/kernels/ops.py::_ssd_chunked_xla``
in torch: per chunk of length Q with inclusive cumsum ``cum`` of ``la``,

    y_intra[i] = sum_{j<=i} exp(cum_i - cum_j) (c_i . b_j) x_j
    y_inter[i] = exp(cum_i) (h c_i)
    h          = exp(cum_{Q-1}) h + sum_j exp(cum_{Q-1} - cum_j) x_j b_j^T

with the (P, N) state in fp32. b and c are shared by the ``H // G`` heads
of a group. The kernel reads its inputs through their strides, so the
transposed views that ``ssm_block`` builds need no copy.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ops import LaunchCounter, use_kernel

COUNTER = LaunchCounter("ssd_scan")
_LIB = "ssd_scan"
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
    """Dynamic shared memory of one kernel block (the layout in ssd_scan.cu)."""
    rows = min(_ROWS, q)
    return 4 * (q * p + 2 * q * (n + 1) + p * (n + 1) + 2 * q + rows * q)


def _entry(dtype: torch.dtype):
    name = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}[dtype]
    fn = getattr(build.library(_LIB), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7  # x, la, b, c, y, dims, stream
        fn.restype = ctypes.c_int
    return fn


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
    chunk = _check(x, la, b, c, chunk)
    if x.dtype not in (torch.float32, torch.bfloat16) or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 x/b/c of one dtype, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if la.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel takes float32 la, got {la.dtype}")
    bb, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    need = smem_bytes(p, n, chunk)
    if need > MAX_SMEM:
        raise ValueError(f"ssd_scan kernel: P={p}, N={n}, chunk={chunk} need {need} bytes "
                         f"of shared memory, more than {MAX_SMEM}")
    y = torch.empty((bb, h, s, p), dtype=x.dtype, device=x.device)
    dims = (ctypes.c_longlong * 22)(bb, h, g, s, p, n, chunk, *x.stride(), *la.stride(),
                                    *b.stride(), *c.stride())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _entry(x.dtype)(x.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(),
                           y.data_ptr(), ctypes.addressof(dims), stream)
    build.check(_LIB, code, "ssd_scan")
    COUNTER.launches += 1
    return y
