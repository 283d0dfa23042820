"""NTX direct convolution, the paper's primary workload kernel (``repro/kernels/conv2d.py``).

NHWC x HWIO -> NHWC, VALID (callers pad), stride >= 1, output in x's dtype.
Per output-row tile of ``th = min(tile_h, OH)`` rows an fp32 accumulator
sums, over the kernel taps (u, v) in order, the strided (th, OW, Cin) slice
of the input times w[u, v] (Cin, Cout), and is rounded once at the store.

:func:`conv2d_ntx` launches a hand-written Hopper kernel on CUDA tensors
and runs the plain version :func:`conv2d_ntx_torch` on CPU tensors.
:func:`entry` picks the kernel from the dtype and the channel counts: bf16
with Cin and Cout multiples of 64 goes to the tensor-core kernel
``csrc/conv2d_ntx_wgmma.cu`` (an implicit GEMM on ``wgmma``, 128 output
pixels per CTA; see :mod:`repro_torch.kernels.conv2d_ntx_wgmma`), fp32
with Cin a multiple of 32 and Cout a multiple of 64 to the tensor-core
kernel ``csrc/conv2d_ntx_tf32.cu`` (the same implicit GEMM in 3xTF32; see
:mod:`repro_torch.kernels.conv2d_ntx_tf32`), and other channel counts
(GoogLeNet's Cin 3 stem) to the FFMA kernel ``csrc/conv2d_ntx.cu`` (one CTA
per image, row tile and 64-channel Cout tile). There is no fallback from
one to another. All read x through its strides and sum each output in one
order that does not depend on ``tile_h``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import conv2d_ntx_tf32 as tf32
from repro_torch.kernels import conv2d_ntx_wgmma as wgmma
from repro_torch.kernels.ops import LaunchCounter, strict_fp32, use_kernel

COUNTER = LaunchCounter("conv2d_ntx")
FFMA = "conv2d_ntx_launch"
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
# C entry -> the library (csrc/<name>.cu) that exports it
ENTRIES = {FFMA: "conv2d_ntx", wgmma.ENTRY: wgmma.LIB, tf32.ENTRY: tf32.LIB}


def _geometry(x: torch.Tensor, w: torch.Tensor, stride: int, tile_h: int):
    """(oh, ow, th) of the conv, after checking its operands."""
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"conv2d_ntx: bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    if stride < 1 or tile_h < 1:
        raise ValueError(f"conv2d_ntx: stride {stride} and tile_h {tile_h} must be positive")
    _, h, wid, _ = x.shape
    kh, kw = w.shape[:2]
    if h < kh or wid < kw:
        raise ValueError(f"conv2d_ntx: input {h}x{wid} is smaller than the kernel {kh}x{kw}")
    oh = (h - kh) // stride + 1
    ow = (wid - kw) // stride + 1
    return oh, ow, min(tile_h, oh)


def conv2d_ntx_torch(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     tile_h: int = 8) -> torch.Tensor:
    """Plain version: per row tile, the (u, v) loop of strided slices times
    w[u, v] into an fp32 accumulator (TF32 off), stored once in x's dtype."""
    oh, ow, th = _geometry(x, w, stride, tile_h)
    COUNTER.plain_calls += 1
    strict_fp32()
    kh, kw, _, cout = w.shape
    s = stride
    xf, wf = x.float(), w.float()
    out = torch.empty((x.shape[0], oh, ow, cout), dtype=x.dtype, device=x.device)
    for r0 in range(0, oh, th):
        rows = min(th, oh - r0)
        acc = torch.zeros((x.shape[0], rows, ow, cout), dtype=torch.float32, device=x.device)
        for u in range(kh):
            for v in range(kw):
                h0 = r0 * s + u
                xs = xf[:, h0:h0 + (rows - 1) * s + 1:s, v:v + (ow - 1) * s + 1:s, :]
                acc += torch.matmul(xs, wf[u, v])
        out[:, r0:r0 + rows] = acc.to(x.dtype)
    return out


def entry(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The C entry a CUDA call launches, from x's dtype and the channel counts.

    bf16 with Cin and Cout multiples of 64 -> ``conv2d_ntx_bf16_wgmma``;
    fp32 with Cin a multiple of 32 and Cout a multiple of 64 ->
    ``conv2d_ntx_f32_tf32`` (both on the tensor cores); other channel counts
    -> ``conv2d_ntx_launch`` (FFMA). Other dtypes raise ``TypeError``.
    """
    if dtype not in _TYPES:
        raise TypeError(f"conv2d_ntx kernel takes float32 or bfloat16 operands, got {dtype}")
    if wgmma.takes(dtype, cin, cout):
        return wgmma.ENTRY
    return tf32.ENTRY if tf32.takes(dtype, cin, cout) else FFMA


def _fn(name: str):
    fn = getattr(build.library(ENTRIES[name]), name)
    if fn.argtypes is None:
        if name == FFMA:  # x, w, y, dtype, N, KH, KW, Cin, Cout, stride, th, OH, OW, 4 strides
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                           + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
        else:  # x, w, y, [ws,] N, KH, KW, Cin, Cout, stride, OH, OW, 3 pixel strides
            fn.argtypes = ([ctypes.c_void_p] * (4 if name == tf32.ENTRY else 3)
                           + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch(name: str, x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           tile_h: int = 8) -> torch.Tensor:
    """Launch C entry ``name`` on CUDA x, w of one dtype; y (N, OH, OW, Cout).

    :func:`conv2d_ntx` calls it with :func:`entry`'s choice; a caller may
    name the FFMA entry for operands the tensor-core entry takes (to time
    it). The tensor-core entries check their operand rules
    (:func:`repro_torch.kernels.conv2d_ntx_wgmma.x_strides`,
    :func:`repro_torch.kernels.conv2d_ntx_tf32.x_strides`); the fp32 one
    also allocates the workspace for w's split, and its first kernel, the
    split, is counted under ``conv2d_ntx_tf32.SPLIT``.
    """
    oh, ow, th = _geometry(x, w, stride, tile_h)
    if not use_kernel(x, w):
        raise ValueError(f"conv2d_ntx: {name} takes CUDA tensors; conv2d_ntx runs the plain "
                         f"version on CPU tensors")
    if x.dtype != w.dtype or x.dtype not in _TYPES:
        raise TypeError(f"conv2d_ntx kernel takes float32 or bfloat16 operands of one type, "
                        f"got {x.dtype}, {w.dtype}")
    n, _, _, cin = x.shape
    kh, kw, _, cout = w.shape
    w = w.contiguous()  # the kernels read w as the (kh*kw*Cin, Cout) matrix
    if name == wgmma.ENTRY:
        if not wgmma.takes(x.dtype, cin, cout):
            raise ValueError(f"{name} takes bf16 with Cin and Cout multiples of "
                             f"{wgmma.CHANNELS}, got {x.dtype}, Cin {cin}, Cout {cout}")
        args = (n, kh, kw, cin, cout, stride, oh, ow, *wgmma.x_strides(x, w))
    elif name == tf32.ENTRY:
        if not tf32.takes(x.dtype, cin, cout):
            raise ValueError(f"{name} takes fp32 with Cin a multiple of {tf32.CIN_STEP} and "
                             f"Cout a multiple of {tf32.COUT_STEP}, got {x.dtype}, Cin {cin}, "
                             f"Cout {cout}")
        strides = tf32.x_strides(x)
        ws = torch.empty(tf32.workspace_numel(kh, kw, cin, cout), dtype=torch.float32,
                         device=x.device)
        args = (ws.data_ptr(), n, kh, kw, cin, cout, stride, oh, ow, *strides)
    elif name == FFMA:
        args = (_TYPES[x.dtype], n, kh, kw, cin, cout, stride, th, oh, ow, *x.stride())
    else:
        raise ValueError(f"conv2d_ntx: no C entry {name!r}; entries are {sorted(ENTRIES)}")
    y = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _fn(name)(x.data_ptr(), w.data_ptr(), y.data_ptr(), *args, stream)
    build.check(ENTRIES[name], code, name)
    COUNTER.launches += 1
    COUNTER.entries[name] = COUNTER.entries.get(name, 0) + 1
    if name == tf32.ENTRY:  # the C entry launched split_w_kernel before the conv
        COUNTER.entries[tf32.SPLIT] = COUNTER.entries.get(tf32.SPLIT, 0) + 1
    return y


def conv2d_ntx(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               tile_h: int = 8) -> torch.Tensor:
    """y[n, i, j, :] = sum over (u, v) of x[n, i*s+u, j*s+v, :] @ w[u, v].

    x (N, H, W, Cin) is pre-padded and may be a strided view; w (kh, kw,
    Cin, Cout). The kernel of :func:`entry` for CUDA tensors, the plain
    version for CPU tensors.
    """
    if not use_kernel(x, w):
        return conv2d_ntx_torch(x, w, stride=stride, tile_h=tile_h)
    _geometry(x, w, stride, tile_h)
    return launch(entry(x.dtype, x.shape[3], w.shape[3]), x, w, stride=stride, tile_h=tile_h)
