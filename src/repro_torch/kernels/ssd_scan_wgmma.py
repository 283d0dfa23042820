"""The tensor-core SSD scan for bf16: shapes, tiles, operand rules, numerics.

``csrc/ssd_scan_wgmma.cu`` (C entry :data:`ENTRY`) computes what
``csrc/ssd_scan.cu`` computes, for bf16 x, b and c (fp32 la) at the shapes
:func:`takes` accepts, in four passes of the chunks in parallel on
``wgmma``: (1) cum in order and each chunk's own state ``S_c = X^T (w o
B)``; (2) ``CB = C B^T`` once per group; (3) the states across chunks,
``h_in[c] = h; h = exp(total_c) h + S_c``, in fp32; (4) ``y = exp(cum_i)
(C h_in^T) + (CB o decay) X``. Each fp32 operand of a product (``w o b``,
``h_in``, the decay-weighted scores) enters as two bf16 terms, ``hi =
bf16(v)`` and ``lo = bf16(v - hi)``, summed in fp32; y is rounded once.

:func:`repro_torch.kernels.ssd_scan.ssd_scan` launches it; this module holds
what the wrapper and the tests need to know about it without a card: which
shapes it takes (:func:`takes`), its shared memory (:func:`smem_bytes`) and
workspace (:func:`workspace_bytes`), TMA's rules on x, b and c
(:func:`tma_strides`), which the wrapper checks and raises on (the kernel
copies nothing), and its numerics in plain PyTorch (:func:`emulate`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ops import strict_fp32

LIB = "ssd_scan_wgmma"  # csrc/ssd_scan_wgmma.cu
ENTRY = "ssd_scan_bf16_wgmma"
BOX = 64  # P and N come in tiles of 64: one TMA box, one wgmma tile
MAX_N = 256  # the largest state dim whose tiles fit one block
CHUNKS = (64, 128)  # the kernel's template instances: one consumer warpgroup per 64 rows
ROW_BYTES = 128  # one swizzled row: 64 bf16


def takes(dtype: torch.dtype, p: int, n: int, chunk: int) -> bool:
    """Whether the kernel computes this scan: bf16 with P a multiple of 64, N
    a multiple of 64 up to 256 and chunks of 64 or 128 tokens."""
    return (dtype == torch.bfloat16 and p > 0 and p % BOX == 0 and 0 < n <= MAX_N
            and n % BOX == 0 and chunk in CHUNKS)


def smem_bytes(n: int, chunk: int) -> dict[str, int]:
    """Dynamic shared memory of one block of each pass that holds tiles, with
    1,024 bytes to align the swizzled tiles: ``states`` the X tile and the B
    tile's two bf16 terms; ``cb`` the C and B tiles; ``out`` the C and X
    tiles and h_in's two terms (64 rows of P)."""
    tile, boxes = chunk * ROW_BYTES, n // BOX
    return {
        "states": 1024 + tile * (1 + 2 * boxes),
        "cb": 1024 + 2 * boxes * tile,
        "out": 1024 + tile * (1 + boxes) + 2 * n * ROW_BYTES,
    }


def workspace_bytes(bsz: int, h: int, g: int, s: int, p: int, n: int, chunk: int) -> int:
    """fp32 workspace of one call: cum (B H S), CB (B G chunks Q Q) and the
    chunk states (B H chunks P N), in that order."""
    nc = s // chunk
    return 4 * (bsz * h * s + bsz * g * nc * chunk * chunk + bsz * h * nc * p * n)


def tma_strides(t: torch.Tensor, name: str) -> tuple[int, int, int, int]:
    """The element strides of a (B, H or G, S, P or N) bf16 operand for its TMA map.

    TMA reads a tensor through a map whose base is 16-byte aligned, whose
    last dim is contiguous and whose other strides are multiples of 16 bytes;
    anything else raises ``ValueError`` (the kernel does not copy).
    """
    size = t.element_size()
    strides = tuple(t.stride())
    if t.dim() != 4 or strides[3] != 1 or t.data_ptr() % 16 or any(
            st * size % 16 for st in strides[:3]):
        raise ValueError(
            f"ssd_scan bf16 wgmma kernel: {name} needs a unit last stride, a 16-byte-aligned "
            f"base and other strides that are multiples of 16 bytes (TMA), got strides "
            f"{strides}, base {t.data_ptr() % 16} bytes past 16")
    return strides


def _terms(v: torch.Tensor, terms: int) -> list[torch.Tensor]:
    hi = v.bfloat16().float()
    return [hi] if terms == 1 else [hi, (v - hi).bfloat16().float()]


def emulate(x: torch.Tensor, la: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
            chunk: int = 128, terms: int = 2) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, with IEEE fp32 sums where the
    tensor cores use their own, on any device: cum in order in fp32; each
    fp32 operand of a product as ``terms`` bf16 terms (``terms=1``, hi
    alone, is the ``one_term`` control); the inter term scaled by exp(cum_i)
    before the intra term is added; y rounded once to x's dtype."""
    if terms not in (1, 2):
        raise ValueError(f"terms must be 1 or 2, got {terms}")
    strict_fp32()
    bb, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    q = min(chunk, s)
    grp, nc = h // g, s // q
    xf = x.float().reshape(bb, g, grp, nc, q, p)
    bf = b.float().reshape(bb, g, 1, nc, q, n)
    cf = c.float().reshape(bb, g, 1, nc, q, n)
    laf = la.float().reshape(bb, g, grp, nc, q)
    cum = torch.empty_like(laf)
    run = torch.zeros_like(laf[..., 0])
    for i in range(q):  # in order, as one thread of pass 1 sums it
        run = run + laf[..., i]
        cum[..., i] = run
    total = cum[..., -1:]
    # pass 1: the chunk states; pass 2: CB once per group
    wb = torch.exp(total - cum)[..., None] * bf
    states = sum(xf.transpose(-1, -2) @ t for t in _terms(wb, terms))  # (.., nc, P, N)
    cb = cf @ bf.transpose(-1, -2)  # (B, G, 1, nc, Q, Q)
    # pass 3: the state each chunk starts from
    dec = torch.exp(total)  # (B, G, grp, nc, 1)
    state = torch.zeros_like(states[:, :, :, 0])
    h_in = []
    for ci in range(nc):
        h_in.append(state)
        state = dec[:, :, :, ci, :, None] * state + states[:, :, :, ci]
    h_in = torch.stack(h_in, dim=3)
    # pass 4: y
    acc = sum(cf @ t.transpose(-1, -2) for t in _terms(h_in, terms))  # (.., nc, Q, P)
    acc = acc * torch.exp(cum)[..., None]
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    # select, never multiply: exp above the diagonal may be inf
    scores = torch.where(causal, cb * torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    for t in _terms(scores, terms):
        acc = acc + t @ xf
    return acc.reshape(bb, h, s, p).to(x.dtype)
