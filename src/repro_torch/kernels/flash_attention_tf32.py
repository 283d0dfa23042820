"""The tensor-core flash-attention kernel for fp32: layout, operand rules, numerics.

``csrc/flash_attention_tf32.cu`` (C entry :data:`ENTRY`) computes what
``csrc/flash_attention.cu`` computes, for fp32 q, k and v at the head dims
of :data:`HEAD_DIMS`, with both products on ``wgmma`` as 3xTF32: each fp32
operand is split into ``hi = tf32_rn(x)`` and ``lo = tf32_rn(x - hi)``, and
each k8 slice of a product takes lo·hi, hi·lo and hi·hi, summed from zero
and added to the running fp32 sum with one IEEE add. In ``q k^T`` a slice
is 8 columns of D; in ``p v`` it is 8 keys, p's split made in registers.
:func:`repro_torch.kernels.flash_attention.flash_attention` launches it;
this module holds what the wrapper and the tests need to know about it
without a card: the tile and shared-memory layout (:func:`smem_bytes`), the
rules on the operands (:func:`operand_strides`), which the wrapper checks
before a launch and raises on (the kernel copies nothing), the key order
of a ``p v`` slice (:func:`pv_key_order`) and the kernel's arithmetic in
plain PyTorch (:func:`emulate`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.gemm_wgmma import split_tf32
from repro_torch.kernels.ops import strict_fp32

LIB = "flash_attention_tf32"  # csrc/flash_attention_tf32.cu
ENTRY = "flash_attention_f32_tf32"
HEAD_DIMS = (64, 128)  # the kernel's template instances
BKV = 64  # keys per tile
SLICE = 8  # K elements of one tf32 wgmma
NEG_INF = -1e30


def warpgroups(d: int) -> int:
    """Consumer warpgroups of a CTA, 64 query rows each: two at D 64 (they
    share each K and V tile), one at D 128 (whose tiles are twice as large)."""
    return 2 if d == 64 else 1


def stages(d: int) -> int:
    """Stages of the K ring and of the V ring: two at D 64, one at D 128."""
    return 2 if d == 64 else 1


def block_q(d: int) -> int:
    """Query rows of a CTA."""
    return 64 * warpgroups(d)


# registers a thread after setmaxnreg where the block has two consumer
# warpgroups: the producer warpgroup gives registers up, the consumers take them
PRODUCER_REGS, CONSUMER_REGS = 88, 208


def registers_needed(d: int) -> int:
    """The least registers a thread the kernel must be built with for its
    setmaxnreg split (0 where it moves none): below it the consumers' increase
    waits for registers the block does not hold, and the block hangs."""
    if warpgroups(d) == 1:
        return 0
    threads = 128 * (warpgroups(d) + 1)
    return -(-(128 * PRODUCER_REGS + 128 * warpgroups(d) * CONSUMER_REGS) // threads)


def kernel_registers(d: int) -> tuple[int, int]:
    """Registers a thread of the built kernel at head dim ``d`` has, and
    :func:`registers_needed` as the C library reckons it; a launch refuses
    when the first is below the second. Builds the library if needed."""
    from repro_torch.kernels import build

    fn = build.library(LIB).flash_attention_tf32_registers
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    needed = ctypes.c_int(0)
    got = fn(d, ctypes.byref(needed))
    if got < 0:
        build.check(LIB, -got, "flash_attention_tf32_registers")
    return got, needed.value


def smem_bytes(d: int) -> int:
    """Shared memory of one block: each warpgroup's q tile, the K and the
    transposed V tiles of every stage, each as a hi and a lo copy in fp32
    (tf32 bits), 1,024 bytes to align the swizzled tiles, and the 8-byte
    mbarriers (q full; K full and empty, V full and empty per stage)."""
    tiles = 2 * 4 * d * (64 * warpgroups(d) + 2 * BKV * stages(d))
    return 1024 + tiles + 8 * (1 + 4 * stages(d))


def operand_strides(t: torch.Tensor, name: str) -> tuple[int, int, int, int]:
    """The element strides of a (B, H, S, D) fp32 operand, after checking the
    kernel's rules.

    The producers read 16 bytes of D at a time, so the operand needs a unit
    last stride, a 16-byte-aligned base and other strides that are
    multiples of 16 bytes (attention_block's transposed views have them);
    anything else raises ``ValueError`` (the kernel does not copy).
    """
    size = t.element_size()
    strides = tuple(t.stride())
    if t.dim() != 4 or strides[3] != 1 or t.data_ptr() % 16 or any(
            st * size % 16 for st in strides[:3]):
        raise ValueError(
            f"flash_attention fp32 tf32 kernel: {name} needs a unit last stride, a "
            f"16-byte-aligned base and other strides that are multiples of 16 bytes, got "
            f"strides {strides}, base {t.data_ptr() % 16} bytes past 16")
    return strides


def pv_key_order() -> list[int]:
    """The keys of an 8-key ``p v`` slice in the order of the tf32 A operand's
    columns: column c of the fragment holds key ``order[c]``.

    The score accumulator gives a thread keys 2t and 2t + 1 of each group
    of 8; tf32's A fragment takes columns t and t + 4. So p goes in as it
    lies, and v's rows are written into shared memory in the same order.
    A slice sums the same 8 keys whichever order its columns take.
    """
    return [2 * t for t in range(4)] + [2 * t + 1 for t in range(4)]


def _slices(a_hi, a_lo, b_hi, b_lo, terms: int) -> torch.Tensor:
    """sum over k8 slices of a @ b^T (a (..., R, K), b (..., C, K)): each
    slice's products summed from zero (lo·hi, then hi·lo, then hi·hi; or
    hi·hi alone for ``terms=1``), then added to the running sum in fp32."""
    out = None
    for k0 in range(0, a_hi.shape[-1], SLICE):
        ks = slice(k0, k0 + SLICE)
        if terms == 1:
            sl = a_hi[..., ks] @ b_hi[..., ks].transpose(-1, -2)
        else:
            sl = a_lo[..., ks] @ b_hi[..., ks].transpose(-1, -2)
            sl = sl + a_hi[..., ks] @ b_lo[..., ks].transpose(-1, -2)
            sl = sl + a_hi[..., ks] @ b_hi[..., ks].transpose(-1, -2)
        out = sl if out is None else out + sl
    return out


def emulate(q, k, v, *, causal: bool = True, window: int | None = None,
            sm_scale: float | None = None, terms: int = 3) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, with IEEE fp32 sums where the
    tensor cores use their own: per tile of :data:`BKV` keys, ``s = q k^T``
    over k8 slices of D, scaled and masked as the kernel does (``NEG_INF``),
    the online max, ``p = exp(s - m)``, l and ``acc * alpha``; then
    ``acc += p v`` slice by slice over 8 keys. ``terms=1`` keeps hi·hi alone
    in both products, the 1xTF32 control. fp32 q, k, v -> fp32 o."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    strict_fp32()
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    grp = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / d**0.5
    qh, ql = (t.reshape(b, hkv, grp, sq, d) for t in split_tf32(q.float()))
    kh, kl = (t[:, :, None] for t in split_tf32(k.float()))
    vh, vl = (t[:, :, None] for t in split_tf32(v.float()))
    rows = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, grp, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, grp, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, skv, BKV):
        ks = slice(k0, k0 + BKV)
        s = _slices(qh, ql, kh[..., ks, :], kl[..., ks, :], terms) * sm_scale
        cols = k0 + torch.arange(s.shape[-1], device=q.device)[None, :]
        mask = torch.ones((sq, s.shape[-1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= cols <= rows
        if window is not None:
            mask &= cols > rows - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        none = m_new <= NEG_INF / 2
        p = torch.where(none, 0.0, torch.exp(s - m_new))
        alpha = torch.where(none, 0.0, torch.exp(m - m_new))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        ph, pl = split_tf32(p)
        vth, vtl = (t[..., ks, :].transpose(-1, -2) for t in (vh, vl))
        acc = acc * alpha
        for j0 in range(0, p.shape[-1], SLICE):
            js = slice(j0, j0 + SLICE)
            acc = acc + _slices(ph[..., js], pl[..., js], vth[..., js], vtl[..., js], terms)
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)).reshape(b, hq, sq, d)
