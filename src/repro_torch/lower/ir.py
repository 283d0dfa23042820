"""The NtxProgram IR (``repro/lower/ir.py``): a whole layer pass or training
step as the NTX driver sees it.

  * :class:`TensorRegion` — a named, shaped window of the flat TCDM address
    space (inputs, parameters, outputs, staging scratch).
  * :class:`CommandBlock` — one command *template* plus the driver-side
    replication loops (``reps``) and the per-level AGU base steps;
    :meth:`CommandBlock.commands` reproduces the exact command stream the
    driver issues, and offload / cycle counts are O(1) properties.
  * :class:`NtxProgram` — ordered blocks + regions + the spec they were
    lowered from: what :func:`repro_torch.lower.executors.run_reference`
    executes command by command, and what
    :func:`repro_torch.lower.fuse.plan_fusion` counts coverage against.
  * :class:`LivenessAllocator` / :class:`RegionAllocator` — the TCDM layout
    by live intervals under the design point's 64 KiB x clusters budget,
    spilling what does not fit above it.

Staging (zero padding, halo blits) is in-band ``memset`` / ``copy`` command
blocks, so executing a program needs no out-of-band padding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Iterator

from repro_torch.core.ntx import MAX_LOOPS, Agu, NtxCommand

ELEM_BYTES = 4  # the NTX datapath streams fp32 words

# The two design points the paper compares (Table 2). ``hw_loops`` is the
# depth of the hardware loop nest, ``n_agus`` the address generators, and
# ``autonomous_writeback`` whether a write AGU exists — without one (NS) at
# most the reduction dims can be offloaded: every output pixel is its own
# command (§2.5(iii)).


@dataclass(frozen=True)
class DesignPoint:
    name: str
    hw_loops: int
    n_agus: int
    autonomous_writeback: bool
    # One cluster's scratchpad (§2.1): the TCDM budget a whole-step program's
    # liveness allocator must fit into is this times the cluster count.
    tcdm_bytes_per_cluster: int = 64 * 1024

    def tcdm_budget_bytes(self, n_clusters: int) -> int:
        return self.tcdm_bytes_per_cluster * n_clusters


NS_DESIGN = DesignPoint("ns", hw_loops=3, n_agus=2, autonomous_writeback=False)
NTX_DESIGN = DesignPoint("ntx", hw_loops=5, n_agus=3, autonomous_writeback=True)


@dataclass(frozen=True)
class TensorRegion:
    """A named window of the flat TCDM address space (element units)."""

    name: str
    base: int
    shape: tuple[int, ...]
    kind: str  # "input" | "param" | "output" | "scratch"

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def end(self) -> int:
        return self.base + self.size

    @property
    def bytes(self) -> int:
        return self.size * ELEM_BYTES


def _rebased(agu: Agu | None, offset: int) -> Agu | None:
    if agu is None or offset == 0:
        return agu
    return Agu(agu.base + offset, agu.strides)


@dataclass(frozen=True)
class CommandBlock:
    """One command template + the driver loop that re-issues it.

    ``reps`` are the driver-side loop bounds (innermost first, may be empty);
    ``rd0_step``/``rd1_step``/``wr_step`` give, per rep level, how far each
    AGU's base moves between consecutive issues — exactly the software loop
    of Table 2 made explicit.
    """

    template: NtxCommand
    reps: tuple[int, ...] = ()
    rd0_step: tuple[int, ...] = ()
    rd1_step: tuple[int, ...] = ()
    wr_step: tuple[int, ...] = ()
    tag: str = ""
    reads: tuple[str, ...] = ()  # region names streamed in
    writes: tuple[str, ...] = ()  # region names streamed out
    dma_bytes_in: float = 0.0  # per command (block read traffic / n_commands)
    dma_bytes_out: float = 0.0
    tile: Any = None  # tiling-plan metadata (core/tiling.py), if any

    def __post_init__(self):
        for steps in (self.rd0_step, self.rd1_step, self.wr_step):
            if len(steps) != len(self.reps):
                raise ValueError(
                    f"AGU step list length {len(steps)} != reps {len(self.reps)}"
                )

    @property
    def n_commands(self) -> int:
        return math.prod(self.reps) if self.reps else 1

    @property
    def busy_cycles_per_command(self) -> int:
        return self.template.busy_cycles

    @property
    def busy_cycles(self) -> int:
        return self.n_commands * self.template.busy_cycles

    @property
    def is_staging(self) -> bool:
        return self.template.opcode in ("copy", "memset")

    def commands(self) -> Iterator[NtxCommand]:
        """The concrete command stream the driver issues, in program order."""
        t = self.template
        if not self.reps:
            yield t
            return
        idx = [0] * len(self.reps)
        n = self.n_commands
        for _ in range(n):
            d0 = sum(i * s for i, s in zip(idx, self.rd0_step))
            d1 = sum(i * s for i, s in zip(idx, self.rd1_step))
            dw = sum(i * s for i, s in zip(idx, self.wr_step))
            yield NtxCommand(
                loops=t.loops,
                opcode=t.opcode,
                agu_rd0=_rebased(t.agu_rd0, d0),
                agu_rd1=_rebased(t.agu_rd1, d1),
                agu_wr=_rebased(t.agu_wr, dw),
                init_level=t.init_level,
                store_level=t.store_level,
                init_value=t.init_value,
            )
            for lvl in range(len(self.reps)):  # odometer, innermost first
                idx[lvl] += 1
                if idx[lvl] < self.reps[lvl]:
                    break
                idx[lvl] = 0


@dataclass
class NtxProgram:
    """An ordered command stream + its memory map: one lowered layer pass."""

    name: str
    blocks: list[CommandBlock]
    regions: dict[str, TensorRegion]
    design: DesignPoint = NTX_DESIGN
    meta: dict[str, Any] = field(default_factory=dict)

    # -- memory map ---------------------------------------------------------

    @property
    def memory_words(self) -> int:
        return max((r.end for r in self.regions.values()), default=0)

    def region(self, name: str) -> TensorRegion:
        return self.regions[name]

    def regions_of_kind(self, kind: str) -> list[TensorRegion]:
        return [r for r in self.regions.values() if r.kind == kind]

    # -- offload accounting (the Table 2 view) ------------------------------

    @property
    def n_offloads(self) -> int:
        """Compute commands the driver issues (staging blits excluded)."""
        return sum(b.n_commands for b in self.blocks if not b.is_staging)

    @property
    def n_staging_offloads(self) -> int:
        return sum(b.n_commands for b in self.blocks if b.is_staging)

    @property
    def n_commands(self) -> int:
        return sum(b.n_commands for b in self.blocks)

    @property
    def busy_cycles(self) -> int:
        """Total datapath cycles (one loop iteration per cycle, §2.3)."""
        return sum(b.busy_cycles for b in self.blocks)

    @property
    def busy_cycles_per_offload(self) -> int:
        """Cycles of the dominant (first non-staging) command template."""
        for b in self.blocks:
            if not b.is_staging:
                return b.busy_cycles_per_command
        return 0

    @property
    def dma_bytes(self) -> float:
        return sum(
            (b.dma_bytes_in + b.dma_bytes_out) * b.n_commands for b in self.blocks
        )

    # -- command stream -----------------------------------------------------

    def commands(self) -> Iterator[NtxCommand]:
        for b in self.blocks:
            yield from b.commands()

    def command_dma_bytes(self) -> Iterator[float]:
        """Per-command input DMA bytes, aligned with :meth:`commands`."""
        for b in self.blocks:
            for _ in range(b.n_commands):
                yield b.dma_bytes_in

    def block_segments(self) -> Iterator[tuple[NtxCommand, int, float]]:
        """(template, n_commands, dma_bytes_in) per block, in program order.

        Every command a block replicates shares the template's loop bounds,
        AGU population and per-command DMA bytes (only bases move), so this
        stream describes the whole program to the timing model without
        materialising a command: what
        :func:`repro_torch.runtime.cmdqueue.simulate_offload_blocks` reads.
        """
        for b in self.blocks:
            yield b.template, b.n_commands, b.dma_bytes_in

    def summary(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "design": self.design.name,
            "n_offloads": self.n_offloads,
            "n_staging_offloads": self.n_staging_offloads,
            "busy_cycles": self.busy_cycles,
            "busy_cycles_per_offload": self.busy_cycles_per_offload,
            "dma_bytes": self.dma_bytes,
            "memory_words": self.memory_words,
        }


#: Sentinel "lives until the end of the program" step index.
LIVE_END = 1 << 62


class LivenessAllocator:
    """Liveness-based TCDM region allocator (interval coloring).

    Regions carry a live interval ``[start, end]`` in *step* units (the graph
    compiler's (node, pass) schedule positions). Allocation walks the steps
    in order: space whose region died strictly before the new region's birth
    is recycled first-fit; only when no gap fits does the watermark grow.
    ``peak_tcdm_bytes`` is therefore the true high-water mark of the laid-out
    program — two regions share addresses only when their live intervals are
    disjoint.

    When a ``budget_words`` is given (the design point's 64 KiB x clusters
    TCDM) and neither a gap nor the remaining headroom fits, the region is
    *spilled*: placed in the DRAM segment that starts at ``budget_words``,
    recorded in :attr:`spilled` so the graph compiler can stage the extra
    DMA traffic in-band. The flat-memory executors are oblivious — a spilled
    region is just an address window above the TCDM watermark — which keeps
    execution bit-identical while the timing model charges for the traffic.

    With ``budget_words=None`` and whole-program lifetimes this degenerates
    to the old back-to-back bump layout (see :class:`RegionAllocator`).
    """

    def __init__(self, budget_words: int | None = None):
        self.budget_words = budget_words
        self.regions: dict[str, TensorRegion] = {}
        self.intervals: dict[str, tuple[int, int]] = {}
        self.spilled: list[str] = []
        self._live: list[list] = []  # [base, size, end] of live TCDM regions
        self._gaps: list[list] = []  # [base, size], sorted by base
        self._top = 0  # TCDM watermark (words)
        self._peak = 0  # historical max watermark
        self._dram_top = budget_words  # spill segment grows from the budget

    # -- bookkeeping --------------------------------------------------------

    @property
    def peak_tcdm_words(self) -> int:
        return self._peak

    @property
    def peak_tcdm_bytes(self) -> int:
        return self._peak * ELEM_BYTES

    def _expire(self, now: int) -> None:
        keep = []
        for rec in self._live:
            if rec[2] < now:
                self._gaps.append([rec[0], rec[1]])
            else:
                keep.append(rec)
        self._live = keep
        # coalesce adjacent gaps so first-fit sees maximal holes
        self._gaps.sort()
        merged: list[list] = []
        for base, size in self._gaps:
            if merged and merged[-1][0] + merged[-1][1] == base:
                merged[-1][1] += size
            else:
                merged.append([base, size])
        # a gap touching the watermark is headroom, not a hole
        if merged and merged[-1][0] + merged[-1][1] == self._top:
            self._top = merged.pop()[0]
        self._gaps = merged

    def _place(self, size: int) -> tuple[int, bool]:
        """First-fit base address for ``size`` words; True when spilled."""
        for gap in self._gaps:
            if gap[1] >= size:
                base = gap[0]
                gap[0] += size
                gap[1] -= size
                if gap[1] == 0:
                    self._gaps.remove(gap)
                return base, False
        if self.budget_words is None or self._top + size <= self.budget_words:
            base = self._top
            self._top += size
            self._peak = max(self._peak, self._top)
            return base, False
        base = self._dram_top
        self._dram_top += size
        return base, True

    # -- the public surface -------------------------------------------------

    def alloc(
        self,
        name: str,
        shape: tuple[int, ...],
        kind: str,
        *,
        start: int = 0,
        end: int = LIVE_END,
    ) -> TensorRegion:
        if name in self.regions:
            raise ValueError(f"region {name!r} already allocated")
        size = math.prod(shape)
        self._expire(start)
        base, spilled = self._place(size)
        r = TensorRegion(name, base, tuple(shape), kind)
        self.regions[name] = r
        self.intervals[name] = (start, end)
        if spilled:
            self.spilled.append(name)
        else:
            self._live.append([base, size, end])
        return r

    def alias(
        self, name: str, of: str, shape: tuple[int, ...], kind: str, *, end: int = LIVE_END
    ) -> TensorRegion:
        """A zero-copy view of an existing region (flatten nodes): same base,
        new shape, and the underlying storage lives at least until ``end``."""
        if name in self.regions:
            raise ValueError(f"region {name!r} already allocated")
        src = self.regions[of]
        if math.prod(shape) != src.size:
            raise ValueError(
                f"alias {name!r} size {math.prod(shape)} != {of!r} size {src.size}"
            )
        r = TensorRegion(name, src.base, tuple(shape), kind)
        self.regions[name] = r
        s0, e0 = self.intervals[of]
        self.intervals[of] = (s0, max(e0, end))
        self.intervals[name] = (s0, end)
        for rec in self._live:
            if rec[0] == src.base and rec[1] == src.size:
                rec[2] = max(rec[2], end)
                break
        return r


class RegionAllocator:
    """Bump allocator laying regions out back to back in TCDM.

    Per-layer lowering keeps the historical behaviour — whole-program
    lifetimes over an unbounded budget make :class:`LivenessAllocator`
    degenerate to exactly the old bump layout.
    """

    def __init__(self):
        self._liv = LivenessAllocator(budget_words=None)

    @property
    def regions(self) -> dict[str, TensorRegion]:
        return self._liv.regions

    def alloc(self, name: str, shape: tuple[int, ...], kind: str) -> TensorRegion:
        return self._liv.alloc(name, shape, kind)
