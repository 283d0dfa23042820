"""Flash attention forward (``repro/kernels/flash_attention.py``).

:func:`flash_attention` launches a hand-written Hopper kernel on CUDA
tensors and runs the plain version :func:`flash_attention_torch` on CPU
tensors; anything else raises. :func:`entry` picks the kernel from the
operands' dtype and head dim: bf16 at D 64 or 128 goes to the tensor-core
kernel ``csrc/flash_attention_wgmma.cu`` (``wgmma`` products, TMA loads, p
in the ``p v`` product as two bf16 terms; see
:mod:`repro_torch.kernels.flash_attention_wgmma`), fp32 at D 64 or 128 to
the tensor-core kernel ``csrc/flash_attention_tf32.cu`` (both products as
3xTF32; see :mod:`repro_torch.kernels.flash_attention_tf32`), and D 16, 32
or 256 to the FFMA kernel ``csrc/flash_attention.cu``. There is no
fallback from one to another. All compute what the TPU kernel's
``_attn_kernel`` computes: scores
``(q . k) * sm_scale`` in fp32, the KV-tail, causal and sliding-window masks
with ``NEG_INF = -1e30``, the online max, sum and accumulator in fp32, rows
with no visible key giving 0, and one rounding of ``o`` to q's dtype. ``p``
enters the ``p v`` product in fp32 in the FFMA kernel and the plain version,
as in the TPU kernel, as two bf16 terms (about 16 bits of p) in the bf16
tensor-core kernel, and as two tf32 terms in the fp32 one. GQA points q head ``h`` at kv
head ``h // (Hq // Hkv)``; KV is never repeated. The kernel reads q, k and v
through their strides, so the transposed views of ``attention_block`` need
no copy.

The plain version walks KV blocks of :data:`BLOCK_KV` (the TPU kernel's
blocking on the prefill path) with all query rows at once. The kernels use
tiles of their own (64 query rows x 64 keys), so they sum in other orders.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention_tf32 as tf32
from repro_torch.kernels import flash_attention_wgmma as wgmma
from repro_torch.kernels.ops import LaunchCounter, use_kernel

COUNTER = LaunchCounter("flash_attention")
NEG_INF = -1e30
_BQ, _BKV = 64, 64  # the FFMA kernel's tile (BQ, BKV in flash_attention.cu)
BLOCK_KV = 512  # the plain version's KV block
HEAD_DIMS = (16, 32, 64, 128, 256)  # the FFMA kernel's template instances
MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
# C entry -> the library (csrc/<name>.cu) that exports it
ENTRIES = {
    "flash_attention_f32": "flash_attention",
    "flash_attention_bf16": "flash_attention",
    wgmma.ENTRY: wgmma.LIB,
    tf32.ENTRY: tf32.LIB,
}


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if hq % k.shape[1]:
        raise ValueError(f"flash_attention: {hq} q heads are not a multiple of "
                         f"{k.shape[1]} kv heads")


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int | None = None,
                          sm_scale: float | None = None) -> torch.Tensor:
    """Plain version: the online softmax over KV blocks of :data:`BLOCK_KV`, fp32."""
    COUNTER.plain_calls += 1
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    grp = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / d**0.5
    qf = q.float().reshape(b, hkv, grp, sq, d)
    kf, vf = k.float(), v.float()
    q_ids = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, grp, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, grp, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, skv, BLOCK_KV):
        kb = kf[:, :, None, k0:k0 + BLOCK_KV]  # (B, Hkv, 1, bkv, D); the tail block is short
        vb = vf[:, :, None, k0:k0 + BLOCK_KV]
        s = (qf @ kb.transpose(-1, -2)) * sm_scale
        kv_ids = k0 + torch.arange(kb.shape[3], device=q.device)[None, :]
        mask = torch.ones((sq, kb.shape[3]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_ids <= q_ids
        if window is not None:
            mask &= kv_ids > q_ids - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        none = m_new <= NEG_INF / 2  # no visible key in the row yet
        p = torch.where(none, 0.0, torch.exp(s - m_new))
        alpha = torch.where(none, 0.0, torch.exp(m - m_new))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vb
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)  # rows with no visible key give 0
    return (acc / l).reshape(b, hq, sq, d).to(q.dtype)


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one FFMA kernel block (the layout in flash_attention.cu)."""
    return 4 * (_BQ * (d + 1) + _BKV * (d + 1) + _BKV * d + _BQ * (_BKV + 1) + 3 * _BQ)


def entry(dtype: torch.dtype, d: int) -> str:
    """The C entry a CUDA call launches, from q's dtype and the head dim.

    At D 64 or 128, bf16 -> ``flash_attention_bf16_wgmma`` and fp32 ->
    ``flash_attention_f32_tf32`` (tensor cores); at D 16, 32 or 256, fp32
    -> ``flash_attention_f32`` and bf16 -> ``flash_attention_bf16`` (FFMA).
    Other dtypes raise ``TypeError``, other head dims ``ValueError``.
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 q/k/v, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} is not one of {HEAD_DIMS}")
    if dtype == torch.bfloat16 and d in wgmma.HEAD_DIMS:
        return wgmma.ENTRY
    if dtype == torch.float32 and d in tf32.HEAD_DIMS:
        return tf32.ENTRY
    return "flash_attention_f32" if dtype == torch.float32 else "flash_attention_bf16"


def _fn(name: str):
    fn = getattr(build.library(ENTRIES[name]), name)
    if fn.argtypes is None:
        # q, k, v, o, dims, sm_scale, stream
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(name: str, q, k, v, *, causal: bool = True, window: int | None = None,
           sm_scale: float | None = None) -> torch.Tensor:
    """Launch C entry ``name`` on CUDA q, k, v of its dtype; o (B, Hq, Sq, D).

    :func:`flash_attention` calls it with :func:`entry`'s choice; a caller
    may name another entry of the operands' dtype (an FFMA kernel at D 64,
    to time it). The tensor-core entries check their operand rules
    (:func:`repro_torch.kernels.flash_attention_wgmma.tma_strides`,
    :func:`repro_torch.kernels.flash_attention_tf32.operand_strides`).
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / d**0.5
    if name == wgmma.ENTRY:
        strides = [wgmma.tma_strides(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    elif name == tf32.ENTRY:
        if q.dtype != torch.float32 or d not in tf32.HEAD_DIMS:
            raise ValueError(f"{name} takes fp32 at head dims {tf32.HEAD_DIMS}, got {q.dtype} "
                             f"at D {d}")
        strides = [tf32.operand_strides(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    else:
        strides = [q.stride(), k.stride(), v.stride()]
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    dims = (ctypes.c_longlong * 21)(
        b, hq, hkv, sq, skv, d, int(causal), int(window is not None),
        0 if window is None else window, *strides[0], *strides[1], *strides[2],
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _fn(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     ctypes.addressof(dims), float(sm_scale), stream)
    build.check(ENTRIES[name], code, name)
    COUNTER.launches += 1
    COUNTER.entries[name] = COUNTER.entries.get(name, 0) + 1
    return o


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Attention with GQA and causal / sliding-window masks; o (B, Hq, Sq, D) in q's dtype."""
    if not use_kernel(q, k, v):
        return flash_attention_torch(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
    _check(q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q/k/v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    return launch(entry(q.dtype, q.shape[3]), q, k, v, causal=causal, window=window,
                  sm_scale=sm_scale)
