"""NTX direct convolution, the paper's primary workload kernel (``repro/kernels/conv2d.py``).

NHWC x HWIO -> NHWC, VALID (callers pad), stride >= 1, output in x's dtype.
Per output-row tile of ``th = min(tile_h, OH)`` rows an fp32 accumulator
sums, over the kernel taps (u, v) in order, the strided (th, OW, Cin) slice
of the input times w[u, v] (Cin, Cout), and is rounded once at the store.

:func:`conv2d_ntx` launches the hand-written Hopper kernel
``csrc/conv2d_ntx.cu`` on CUDA tensors (one CTA per image, row tile and
64-channel Cout tile; x read through its strides) and runs the plain version
:func:`conv2d_ntx_torch` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ops import LaunchCounter, strict_fp32, use_kernel

COUNTER = LaunchCounter("conv2d_ntx")
_LIB = "conv2d_ntx"
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _entry():
    fn = build.library(_LIB).conv2d_ntx_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_longlong] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def conv2d_ntx(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               tile_h: int = 8) -> torch.Tensor:
    """y[n, i, j, :] = sum over (u, v) of x[n, i*s+u, j*s+v, :] @ w[u, v].

    x (N, H, W, Cin) is pre-padded and may be a strided view; w (kh, kw,
    Cin, Cout). The kernel for CUDA tensors, the plain version for CPU tensors.
    """
    oh, ow, th = _geometry(x, w, stride, tile_h)
    if not use_kernel(x, w):
        return conv2d_ntx_torch(x, w, stride=stride, tile_h=tile_h)
    if x.dtype != w.dtype or x.dtype not in _TYPES:
        raise TypeError(f"conv2d_ntx kernel takes float32 or bfloat16 operands of one type, "
                        f"got {x.dtype}, {w.dtype}")
    n, _, _, cin = x.shape
    kh, kw, _, cout = w.shape
    w = w.contiguous()  # the kernel reads w as the (kh*kw*Cin, Cout) matrix
    y = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _entry()(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), _TYPES[x.dtype], n, kh, kw, cin, cout,
        stride, th, oh, ow, *x.stride(), stream,
    )
    build.check(_LIB, code, "conv2d_ntx")
    COUNTER.launches += 1
    return y
