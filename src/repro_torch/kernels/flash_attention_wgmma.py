"""The tensor-core flash-attention kernel for bf16: layout and operand rules.

``csrc/flash_attention_wgmma.cu`` (C entry :data:`ENTRY`) computes what
``csrc/flash_attention.cu`` computes, for bf16 q, k and v at the head dims
of :data:`HEAD_DIMS`, with ``wgmma`` products and TMA loads; p enters the
``p v`` product as two bf16 terms, ``p_hi = bf16(p)`` and
``p_lo = bf16(p - p_hi)``, summed in fp32. :func:`repro_torch.kernels.
flash_attention.flash_attention` launches it; this module holds what the
wrapper and the tests need to know about it without a card: the tile and
shared-memory layout (:func:`smem_bytes`) and TMA's rules on the operands
(:func:`tma_strides`), which the wrapper checks before a launch and raises
on: the kernel copies nothing.
"""

from __future__ import annotations

import torch

LIB = "flash_attention_wgmma"  # csrc/flash_attention_wgmma.cu
ENTRY = "flash_attention_bf16_wgmma"
HEAD_DIMS = (64, 128)  # the kernel's template instances
BQ, BKV = 64, 64  # query rows per CTA (one warpgroup), keys per tile


def stages(d: int) -> int:
    """Buffers in the K / V ring (``Layout<D>::STAGES``): 3 at D 64, 2 at D 128,
    so that two CTAs still share an SM at D 128."""
    return 3 if d == 64 else 2


def smem_bytes(d: int) -> int:
    """Shared memory of one block: the q tile, ``stages(d)`` K and V tiles in
    bf16, 1,024 bytes to align the swizzled tiles, and the 8-byte mbarriers
    (q; K full, V full and empty per stage)."""
    tiles = 2 * d * (BQ + 2 * stages(d) * BKV)
    return 1024 + tiles + 8 * (1 + 3 * stages(d))


def tma_strides(t: torch.Tensor, name: str) -> tuple[int, int, int, int]:
    """The element strides of a (B, H, S, D) bf16 operand for its TMA map.

    TMA reads a tensor through a map whose base is 16-byte aligned, whose
    last dim is contiguous and whose other strides are multiples of 16 bytes;
    anything else raises ``ValueError`` (the kernel does not copy).
    """
    size = t.element_size()
    strides = tuple(t.stride())
    if t.dim() != 4 or strides[3] != 1 or t.data_ptr() % 16 or any(
            st * size % 16 for st in strides[:3]):
        raise ValueError(
            f"flash_attention bf16 wgmma kernel: {name} needs a unit last stride, a "
            f"16-byte-aligned base and other strides that are multiples of 16 bytes "
            f"(TMA), got strides {strides}, base {t.data_ptr() % 16} bytes past 16")
    return strides
