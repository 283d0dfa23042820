"""The tensor-core SSD scan for fp32: shapes, tiles, operand rules, numerics.

``csrc/ssd_scan_tf32.cu`` (C entry :data:`ENTRY`) computes what
``csrc/ssd_scan.cu`` computes, for fp32 x, b and c (fp32 la) at the shapes
:func:`takes` accepts, in the four passes of the bf16 kernel
(``csrc/ssd_scan_wgmma.cu``) with the chunks in parallel: (1) cum in order
in fp64 and each chunk's own state ``S_c = (w o X)^T B``, ``w_j =
exp(total - cum_j)`` (every decay from an fp64 difference of cums); (2)
``CB = C B^T`` once per group; (3) the states across chunks,
``h_in[c] = h; h = exp(total_c) h + S_c``, in fp32 (the bf16 kernel's scan
pass, shared through ``csrc/ssd_scan_common.cuh``); (4) ``y = exp(cum_i)
(C h_in^T) + (CB o decay) X``. Every product runs on ``wgmma`` as 3xTF32
(``hi = tf32_rn(v)``, ``lo = tf32_rn(v - hi)``; per k8 slice lo·hi, hi·lo,
hi·hi summed from zero), and every fp32 sum has one order: the four slices
of a stage of :data:`KBOX` K elements summed from zero by IEEE adds, the
stage's sum added to the running sum by one more. y is stored in fp32.

:func:`repro_torch.kernels.ssd_scan.ssd_scan` launches it; this module holds
what the wrapper and the tests need to know about it without a card: which
shapes it takes (:func:`takes`), its shared memory (:func:`smem_bytes`) and
workspace (:func:`workspace_bytes`), its rules on x, b and c
(:func:`operand_strides`), which the wrapper checks and raises on (the
kernel copies nothing), and its arithmetic in plain PyTorch
(:func:`emulate`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gemm_wgmma import split_tf32
from repro_torch.kernels.ops import strict_fp32

LIB = "ssd_scan_tf32"  # csrc/ssd_scan_tf32.cu
ENTRY = "ssd_scan_f32_tf32"
TILE = 64  # rows and columns of one wgmma tile: P and N come in tiles of 64
MAX_N = 256  # the largest state dim the kernel takes
CHUNKS = (64, 128)  # the kernel's template instances: one consumer warpgroup per 64 rows
KBOX = 32  # K elements of one stage: one 128-byte swizzled row of fp32
SLICE = 8  # K elements of one tf32 wgmma
ROW_BYTES = 128
STAGE_TILE = TILE * ROW_BYTES  # one 64-row tile of one stage, hi or lo


def takes(dtype: torch.dtype, p: int, n: int, chunk: int) -> bool:
    """Whether the kernel computes this scan: fp32 with P a multiple of 64, N
    a multiple of 64 up to 256 and chunks of 64 or 128 tokens (the Mamba-2
    780M's P 64, N 128, chunk 128 among them)."""
    return (dtype == torch.float32 and p > 0 and p % TILE == 0 and 0 < n <= MAX_N
            and n % TILE == 0 and chunk in CHUNKS)


def smem_bytes(chunk: int) -> dict[str, int]:
    """Dynamic shared memory of one block of each pass that holds tiles: two
    stages (a double buffer), each the hi and lo of its 64-row tiles, and
    1,024 bytes to align the swizzled tiles. ``states``: the (w o X)^T tile
    and two B^T tiles a stage; ``cb``: the C and B tiles of every 64 rows of
    the chunk; ``out``: the C tiles of every 64 rows of the chunk and the
    h_in (then X^T) tile."""
    rows = chunk // TILE
    tiles = {"states": 3, "cb": 2 * rows, "out": rows + 1}
    return {k: 1024 + 2 * 2 * t * STAGE_TILE for k, t in tiles.items()}


def workspace_bytes(bsz: int, h: int, g: int, s: int, p: int, n: int, chunk: int) -> int:
    """fp32 workspace of one call: cum (B H S), CB (B G chunks Q Q) and the
    chunk states (B H chunks P N), in that order (the bf16 kernel's)."""
    nc = s // chunk
    return 4 * (bsz * h * s + bsz * g * nc * chunk * chunk + bsz * h * nc * p * n)


def operand_strides(t: torch.Tensor, name: str) -> tuple[int, int, int, int]:
    """The element strides of a (B, H or G, S, P or N) fp32 operand, after
    checking the kernel's rules.

    The kernel reads rows of x, b and c 16 bytes at a time, so each needs a
    unit last stride, other strides that are multiples of 4 elements and a
    16-byte-aligned base; anything else raises ``ValueError`` (the kernel
    does not copy).
    """
    strides = tuple(t.stride())
    if t.dim() != 4 or strides[3] != 1 or t.data_ptr() % 16 or any(
            st * t.element_size() % 16 for st in strides[:3]):
        raise ValueError(
            f"ssd_scan fp32 tf32 kernel: {name} needs a unit last stride, a 16-byte-aligned "
            f"base and other strides that are multiples of 16 bytes, got strides {strides}, "
            f"base {t.data_ptr() % 16} bytes past 16")
    return strides


def _products(a: torch.Tensor, b: torch.Tensor, terms: int,
              acc: torch.Tensor | None = None) -> torch.Tensor:
    """``acc`` + a (..., M, K) @ b (..., K, N) as the kernel sums it: per
    stage of KBOX K elements, each k8 slice's products from zero (lo·hi,
    + hi·lo, + hi·hi; ``terms=1``: hi·hi alone), the slices summed from zero,
    the stages added to the running sum ``acc`` (none: zero) in order."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    pairs = [(ah, bh)] if terms == 1 else [(al, bh), (ah, bl), (ah, bh)]
    k = a.shape[-1]
    for k0 in range(0, k, KBOX):
        part = None
        for k1 in range(k0, min(k0 + KBOX, k), SLICE):
            cs = slice(k1, k1 + SLICE)
            sl = None
            for p, q in pairs:
                t = p[..., cs] @ q[..., cs, :]
                sl = t if sl is None else sl + t
            part = sl if part is None else part + sl
        acc = part if acc is None else acc + part
    return acc


def emulate(x: torch.Tensor, la: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
            chunk: int = 128, terms: int = 3) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, with IEEE fp32 sums where the
    tensor cores use their own, on any device: cum in fp64, the decays from
    its differences; ``w_j x_j`` rounded to fp32 before its split; every product in 3xTF32 summed as
    :func:`_products` sums it (``terms=1``, hi·hi alone, is the 1xTF32
    control); the inter term scaled by exp(cum_i), then each stage of the
    intra term added to it. fp32 in, fp32 y out."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    strict_fp32()
    bb, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    q = min(chunk, s)
    grp, nc = h // g, s // q
    xf = x.float().reshape(bb, g, grp, nc, q, p)
    bf = b.float().reshape(bb, g, 1, nc, q, n)
    cf = c.float().reshape(bb, g, 1, nc, q, n)
    laf = la.float().reshape(bb, g, grp, nc, q)
    # in fp64 (each rounded once for exp(cum_i) and the scan); the decays
    # exp(total - cum_j) and exp(cum_i - cum_j) from the fp64 differences,
    # which do not cancel as the rounded cums' do
    cum64 = torch.cumsum(laf.double(), dim=-1)
    cum = cum64.float()
    total = cum[..., -1:]
    # pass 1: the chunk states; pass 2: CB once per group
    wx = torch.exp((cum64[..., -1:] - cum64).float())[..., None] * xf
    states = _products(wx.transpose(-1, -2), bf, terms)  # (.., nc, P, N)
    cb = _products(cf, bf.transpose(-1, -2), terms)  # (B, G, 1, nc, Q, Q)
    # pass 3: the state each chunk starts from
    dec = torch.exp(total)  # (B, G, grp, nc, 1)
    state = torch.zeros_like(states[:, :, :, 0])
    h_in = []
    for ci in range(nc):
        h_in.append(state)
        state = dec[:, :, :, ci, :, None] * state + states[:, :, :, ci]
    h_in = torch.stack(h_in, dim=3)
    # pass 4: y
    acc = _products(cf.expand(-1, -1, grp, -1, -1, -1), h_in.transpose(-1, -2), terms)
    acc = acc * torch.exp(cum)[..., None]
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    # select, never multiply: exp above the diagonal may be inf
    decay = torch.exp((cum64[..., :, None] - cum64[..., None, :]).float())
    scores = torch.where(causal, cb * decay, 0.0)
    return _products(scores, xf, terms, acc).reshape(bb, h, s, p)
