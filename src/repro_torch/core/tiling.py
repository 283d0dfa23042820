"""On-the-fly tile planning (paper §3.1, §4.5), copied from ``repro/core/tiling.py``.

The planner picks block shapes for the TPU under a VMEM budget. Its
constants are the TPU's (128 lanes, a 16 MiB budget) and stay so: the K
block that :func:`plan_matmul_tiles` picks is the K tile of
``kernels/ntx_matmul.py``, and the K tiling decides where that kernel's
fp32 sums round. On Hopper the block shapes set no CTA tile.
"""

from __future__ import annotations

from dataclasses import dataclass

# Conservative usable VMEM per TensorCore. v5e has ~128 MiB of on-chip vector
# memory headline, but the compiler owns a share; kernels plan against 16 MiB
# unless told otherwise (the paper plans against its 128 KiB TCDM the same way).
DEFAULT_VMEM_BUDGET = 16 * 1024 * 1024
LANE = 128  # lane count: last-dim alignment for the VPU/MXU
MIN_BURST_ELEMS = 8  # paper §4.1.3: innermost dim >= 8 elems => bursts >= 32 B


def sublane(dtype_bytes: int) -> int:
    """Second-to-last dim packing for a dtype (8 for fp32, 16 for bf16...)."""
    return max(8, 32 // dtype_bytes)


@dataclass(frozen=True)
class MatmulTilePlan:
    """Block shapes for C[M,N] += A[M,K] @ B[K,N] with an fp32 accumulator."""

    bm: int
    bn: int
    bk: int
    vmem_bytes: int
    grid: tuple[int, int, int]  # (m_tiles, n_tiles, k_tiles)

    @property
    def arithmetic_intensity(self) -> float:
        """flops per HBM byte moved for one (bm,bn) output tile."""
        flops = 2 * self.bm * self.bn * self.bk * self.grid[2]
        k = self.bk * self.grid[2]
        bytes_moved = (self.bm * k + k * self.bn) * 2 + self.bm * self.bn * 4
        return flops / bytes_moved


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_down_pow2_mult(x: int, m: int) -> int:
    """Largest multiple of m that is <= x (at least m)."""
    return max(m, (x // m) * m)


def plan_matmul_tiles(
    m: int,
    n: int,
    k: int,
    in_dtype_bytes: int = 2,
    vmem_budget: int = DEFAULT_VMEM_BUDGET,
    acc_bytes: int = 4,
) -> MatmulTilePlan:
    """Choose MXU-aligned (bm, bn, bk) fitting double-buffered VMEM.

    Footprint (Pallas pipeline double-buffers inputs, accumulator is single):
        2*(bm*bk + bk*bn)*in_bytes + bm*bn*acc_bytes  <=  budget

    Strategy mirrors the paper's tiling goals: maximize reuse (big bm x bn
    output tile => each A/B byte used bn/bm times) while keeping bursts long
    (bk spans the full K when it fits, so the innermost stream is contiguous).
    """
    bm = _round_down_pow2_mult(min(m, 512), LANE)
    bn = _round_down_pow2_mult(min(n, 512), LANE)
    bk = _round_down_pow2_mult(min(k, 2048), LANE)

    def fits(bm, bn, bk):
        return 2 * (bm * bk + bk * bn) * in_dtype_bytes + bm * bn * acc_bytes <= vmem_budget

    # Shrink greedily: K first (reuse is insensitive to bk), then the larger
    # of bm/bn, never below one MXU tile.
    while not fits(bm, bn, bk):
        if bk > LANE:
            bk //= 2
        elif bm >= bn and bm > LANE:
            bm //= 2
        elif bn > LANE:
            bn //= 2
        else:
            break
    grid = (_round_up(m, bm) // bm, _round_up(n, bn) // bn, _round_up(k, bk) // bk)
    vmem = 2 * (bm * bk + bk * bn) * in_dtype_bytes + bm * bn * acc_bytes
    return MatmulTilePlan(bm=bm, bn=bn, bk=bk, vmem_bytes=vmem, grid=grid)


@dataclass(frozen=True)
class StencilTilePlan:
    """Tile for a stencil (conv/pool) op over an NHWC tensor (paper §3.1)."""

    th: int  # tile height (output rows)
    tw: int  # tile width (output cols)
    halo: int  # overlap rows/cols needed from neighbours (kernel-1)
    vmem_bytes: int
    burst_elems: int  # innermost contiguous run (>= MIN_BURST_ELEMS)


def plan_stencil_tiles(
    h: int,
    w: int,
    cin: int,
    cout: int,
    kh: int,
    kw: int,
    dtype_bytes: int = 4,
    vmem_budget: int = DEFAULT_VMEM_BUDGET,
) -> StencilTilePlan:
    """Pick an output tile (th, tw) so in+out+weights double-buffer in VMEM.

    The channel dim stays whole (it is the innermost, contiguous one — this is
    what keeps DMA bursts long, paper Fig. 11) and we shrink spatial dims.
    """
    halo = max(kh, kw) - 1
    th, tw = min(h, 64), min(w, 64)

    def fits(th, tw):
        inp = (th + halo) * (tw + halo) * cin
        out = th * tw * cout
        wgt = kh * kw * cin * cout
        return (2 * inp + 2 * out + wgt) * dtype_bytes <= vmem_budget

    while not fits(th, tw) and (th > 1 or tw > 1):
        if tw >= th and tw > 1:
            tw = max(1, tw // 2)
        else:
            th = max(1, th // 2)
    inp = (th + halo) * (tw + halo) * cin
    out = th * tw * cout
    wgt = kh * kw * cin * cout
    return StencilTilePlan(
        th=th,
        tw=tw,
        halo=halo,
        vmem_bytes=(2 * inp + 2 * out + wgt) * dtype_bytes,
        burst_elems=max(cin, MIN_BURST_ELEMS),
    )
