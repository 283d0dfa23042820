"""Multi-cluster work scheduler over the command-queue + DMA runtime.

Counterpart of ``repro/runtime/scheduler.py``. The top of the offload
stack: take an :class:`~repro_torch.core.ntx.NtxCommand`
loop nest (or a whole layer's worth of them), split it across the HMC's
clusters (§3.1's tiling over vaults), feed every cluster's driver its share,
and simulate the queues + DMA to a per-engine timeline.

  * :func:`partition_command` — split a command's outermost free loop into
    independent sub-commands with rebased AGUs (the driver-side loop of
    Table 2 made explicit). Executing the parts sequentially through
    ``ntx_execute`` is bit-identical to the original command.
  * :class:`MultiClusterScheduler` — round-robins commands over clusters,
    runs :func:`~repro_torch.runtime.cmdqueue.simulate_offload` per cluster with
    the vault-capped DMA config, and collects a :class:`Timeline`.
  * :func:`simulate_workload` — the event-driven counterpart of the paper's
    analytical model (benchmarks/ntx_model.py eqs. 4-11): same calibration
    constants, but the overlap emerges from the simulated double-buffered
    pipeline instead of a ``max()``. The two must agree within ~10% on the
    paper's workloads.

Timelines export as Chrome ``chrome://tracing`` / Perfetto JSON.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field, replace
from typing import Sequence

from repro_torch.core.ntx import Agu, NtxCommand
from repro_torch.runtime import dma as dma_mod
from repro_torch.runtime.cmdqueue import (
    BlockSegment,
    OffloadTrace,
    simulate_offload,
    simulate_offload_blocks,
)

# Compute-side calibration, identical to benchmarks/ntx_model.py (pinned by a
# test there): per-kernel NTX utilization and full-network derating.
ETA_COMPUTE = 0.84
ETA_NET = 0.855
ENGINES_PER_CLUSTER = 8  # NTX co-processors per RISC-V driver (§2.1)

# schedule_program(engine="auto"): programs above this command count take the
# block-replicated steady-state path (identical cycle counts, O(blocks) time);
# below it the full event-driven run keeps complete per-command traces.
BLOCK_ENGINE_THRESHOLD = 50_000


# ---------------------------------------------------------------------------
# Loop-nest partitioning
# ---------------------------------------------------------------------------


def _rebase(agu: Agu | None, level: int, start: int) -> Agu | None:
    if agu is None:
        return None
    return Agu(agu.base + start * agu.strides[level], agu.strides)


def partition_command(cmd: NtxCommand, parts: int) -> list[NtxCommand]:
    """Split ``cmd`` along its outermost non-unit loop into ≤ ``parts`` pieces.

    The split loop must sit at or above the accumulator's init/store levels so
    no accumulation region crosses a part boundary — each piece is then an
    independent command (what the driver's software loop iterates in Table 2).
    """
    level = None
    for l in range(len(cmd.loops) - 1, -1, -1):
        if cmd.loops[l] > 1:
            level = l
            break
    if level is None or parts <= 1:
        return [cmd]
    if cmd.init_level > level or cmd.store_level > level:
        raise ValueError(
            f"cannot split loop L{level}: accumulator spans it "
            f"(init_level={cmd.init_level}, store_level={cmd.store_level})"
        )
    n = cmd.loops[level]
    parts = min(parts, n)
    base_sz, rem = divmod(n, parts)
    out = []
    start = 0
    for p in range(parts):
        sz = base_sz + (1 if p < rem else 0)
        loops = list(cmd.loops)
        loops[level] = sz
        out.append(
            NtxCommand(
                loops=tuple(loops),
                opcode=cmd.opcode,
                agu_rd0=_rebase(cmd.agu_rd0, level, start),
                agu_rd1=_rebase(cmd.agu_rd1, level, start),
                agu_wr=_rebase(cmd.agu_wr, level, start),
                init_level=cmd.init_level,
                store_level=cmd.store_level,
                init_value=cmd.init_value,
            )
        )
        start += sz
    return out


def partition_program(program, parts: int):
    """Refine a lowered program's blocks into up to ``parts`` template pieces.

    Each block's command *template* is split along its outermost splittable
    free loop (:func:`partition_command`, which refuses to tear accumulation
    regions — such blocks stay whole); every piece keeps the block's driver
    replication loops, so a block with ``n`` commands becomes up to
    ``parts`` blocks of ``n`` commands each. Executing the refined program
    is bit-identical to the original (the pieces partition each command's
    iteration space), but the finer offload granularity is what lets one
    layer fill many clusters x engines — §3.1's tiling applied at the
    program level. Per-command DMA descriptors are scaled so total traffic
    is preserved.
    """
    from repro_torch.lower.ir import NtxProgram

    new_blocks = []
    for b in program.blocks:
        try:
            pieces = partition_command(b.template, parts)
        except ValueError:
            pieces = [b.template]
        for p in pieces:
            new_blocks.append(
                replace(
                    b,
                    template=p,
                    dma_bytes_in=b.dma_bytes_in / len(pieces),
                    dma_bytes_out=b.dma_bytes_out / len(pieces),
                )
            )
    return NtxProgram(
        name=f"{program.name}:part{parts}",
        blocks=new_blocks,
        regions=program.regions,
        design=program.design,
        meta={**program.meta, "partitioned": parts},
    )


# ---------------------------------------------------------------------------
# Timeline / trace export
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceEvent:
    name: str
    cat: str  # "program" | "dma" | "exec"
    cluster: int
    engine: int  # -1 == the driver core
    t0: int
    t1: int


@dataclass
class Timeline:
    events: list[TraceEvent] = field(default_factory=list)

    def add_trace(self, cluster: int, trace: OffloadTrace) -> None:
        for i, r in enumerate(trace.records):
            name = f"cmd{i}:{r.cmd.opcode}"
            self.events.append(TraceEvent(name, "program", cluster, -1,
                                          r.program_start, r.issue_t))
            if r.dma_end > r.dma_start:
                self.events.append(TraceEvent(name, "dma", cluster, r.engine,
                                              r.dma_start, r.dma_end))
            self.events.append(TraceEvent(name, "exec", cluster, r.engine,
                                          r.exec_start, r.retire_t))

    def to_chrome_trace(self) -> dict:
        """chrome://tracing "X" (complete) events; pid=cluster, tid=engine."""
        out = []
        for e in self.events:
            tid = "driver" if e.engine < 0 else f"ntx{e.engine}"
            out.append({
                "name": e.name, "cat": e.cat, "ph": "X",
                "pid": f"cluster{e.cluster}", "tid": tid,
                "ts": e.t0, "dur": max(e.t1 - e.t0, 0),
                "args": {"cycles": e.t1 - e.t0},
            })
        return {"traceEvents": out, "displayTimeUnit": "ns"}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


# ---------------------------------------------------------------------------
# Multi-cluster scheduling
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClusterConfig:
    n_engines: int = ENGINES_PER_CLUSTER
    queue_depth: int = 4
    sync: bool = False
    dma: dma_mod.DmaConfig = field(default_factory=dma_mod.DmaConfig)
    dma_overlap: bool = True


@dataclass
class ScheduleResult:
    cluster_traces: list[OffloadTrace]
    timeline: Timeline

    @property
    def total_cycles(self) -> int:
        return max((t.stats.total_cycles for t in self.cluster_traces), default=0)

    @property
    def exec_cycles(self) -> int:
        return sum(t.stats.exec_cycles for t in self.cluster_traces)

    @property
    def utilization(self) -> float:
        engines = sum(t.stats.n_engines for t in self.cluster_traces)
        return self.exec_cycles / max(engines * self.total_cycles, 1)

    def summary(self) -> dict:
        s0 = self.cluster_traces[0].stats if self.cluster_traces else None
        return {
            "clusters": len(self.cluster_traces),
            "total_cycles": self.total_cycles,
            "utilization": self.utilization,
            "queue_depth": s0.queue_depth if s0 else 0,
            "n_commands": sum(t.stats.n_commands for t in self.cluster_traces),
            "dma_stall_cycles": sum(t.stats.dma_stall_cycles
                                    for t in self.cluster_traces),
            "queue_stall_cycles": sum(t.stats.queue_stall_cycles
                                      for t in self.cluster_traces),
            "overhead_cycles": sum(t.stats.overhead_cycles
                                   for t in self.cluster_traces),
            "elided_commands": sum(t.elided_commands
                                   for t in self.cluster_traces),
        }


class MultiClusterScheduler:
    """Partition command streams across clusters and simulate each one."""

    def __init__(self, n_clusters: int = 1,
                 cluster: ClusterConfig | None = None,
                 f_ntx: float = 1.5e9):
        self.n_clusters = n_clusters
        self.cluster = cluster or ClusterConfig()
        self.f_ntx = f_ntx
        # every cluster sees its share of the vault crossbar
        self._dma = self.cluster.dma.capped(n_clusters, f_ntx)

    def distribute(self, cmd: NtxCommand) -> list[list[NtxCommand]]:
        """Split one big command into per-cluster work lists."""
        parts = partition_command(cmd, self.n_clusters)
        buckets: list[list[NtxCommand]] = [[] for _ in range(self.n_clusters)]
        for i, p in enumerate(parts):
            buckets[i % self.n_clusters].append(p)
        return buckets

    def schedule(
        self,
        commands: Sequence[NtxCommand] | Sequence[Sequence[NtxCommand]],
        *,
        bytes_per_command: Sequence[float] | None = None,
        exec_cycles=None,
    ) -> ScheduleResult:
        """Simulate ``commands`` over the clusters.

        A flat sequence is dealt round robin; a pre-bucketed list of lists
        (e.g. from :meth:`distribute`) is used as-is. ``bytes_per_command``
        (flat, same order) attaches an input DMA transfer to each command.
        """
        if commands and isinstance(commands[0], NtxCommand):
            buckets = [list(commands[i::self.n_clusters])
                       for i in range(self.n_clusters)]
            byte_buckets = (
                [list(bytes_per_command[i::self.n_clusters])
                 for i in range(self.n_clusters)]
                if bytes_per_command is not None else None
            )
        else:
            buckets = [list(b) for b in commands]
            if bytes_per_command is not None:
                byte_buckets, it = [], iter(bytes_per_command)
                for b in buckets:
                    byte_buckets.append([next(it) for _ in b])
            else:
                byte_buckets = None

        timeline = Timeline()
        traces = []
        for c, bucket in enumerate(buckets):
            dma_cycles = None
            if byte_buckets is not None:
                dma_cycles = [
                    self._dma.transfer_cycles(dma_mod.Transfer(nb))
                    for nb in byte_buckets[c]
                ]
            trace = simulate_offload(
                bucket,
                n_engines=self.cluster.n_engines,
                queue_depth=self.cluster.queue_depth,
                sync=self.cluster.sync,
                exec_cycles=exec_cycles,
                dma_cycles=dma_cycles,
                dma_overlap=self.cluster.dma_overlap,
                dma_buffers=self._dma.n_buffers,
            )
            timeline.add_trace(c, trace)
            traces.append(trace)
        return ScheduleResult(cluster_traces=traces, timeline=timeline)

    def program_segments(self, program) -> list[list[BlockSegment]]:
        """Per-cluster :class:`BlockSegment` lists for ``program``.

        Reproduces exactly the round-robin deal of :meth:`schedule` — global
        command ``i`` lands on cluster ``i % n_clusters`` at bucket position
        ``i // n_clusters`` — without materializing a single command: each
        block contributes one segment per cluster, sized by how many of the
        block's replicas fall on that cluster.
        """
        segs: list[list[BlockSegment]] = [[] for _ in range(self.n_clusters)]
        g = 0  # global index of the block's first command
        for template, count, dma_bytes_in in program.block_segments():
            dc = (
                self._dma.transfer_cycles(dma_mod.Transfer(dma_bytes_in))
                if dma_bytes_in
                else 0
            )
            for c in range(self.n_clusters):
                first = g + ((c - g) % self.n_clusters)
                if first < g + count:
                    share = (g + count - 1 - first) // self.n_clusters + 1
                    segs[c].append(BlockSegment(template, share, dc))
            g += count
        return segs

    def schedule_program(self, program, *, engine: str = "auto",
                         exec_cycles=None) -> ScheduleResult:
        """Simulate a lowered :class:`repro_torch.lower.ir.NtxProgram`.

        The command stream and the per-command DMA byte counts both come
        from the program — this is the timing-executor entry point
        (:func:`repro_torch.lower.executors.run_timing` wraps it).

        ``engine`` selects the simulation strategy:

          * ``"event"`` — materialize every command and run the full
            event-driven simulation (complete per-command traces).
          * ``"block"`` — the block-replicated steady-state fast path
            (:func:`repro_torch.runtime.cmdqueue.simulate_offload_blocks`):
            identical cycle counts, O(blocks) instead of O(commands).
          * ``"auto"`` — ``"block"`` above ``BLOCK_ENGINE_THRESHOLD``
            commands, ``"event"`` below.

        ``exec_cycles`` overrides per-command datapath cycles (e.g. an
        eta-derated ``busy_cycles``); on the block path it must not depend
        on AGU bases.
        """
        if engine == "auto":
            engine = (
                "block" if program.n_commands > BLOCK_ENGINE_THRESHOLD
                else "event"
            )
        if engine == "event":
            return self.schedule(
                list(program.commands()),
                bytes_per_command=list(program.command_dma_bytes()),
                exec_cycles=exec_cycles,
            )
        if engine != "block":
            raise ValueError(f"unknown timing engine {engine!r}")
        timeline = Timeline()
        traces = []
        for c, segs in enumerate(self.program_segments(program)):
            trace = simulate_offload_blocks(
                segs,
                n_engines=self.cluster.n_engines,
                queue_depth=self.cluster.queue_depth,
                sync=self.cluster.sync,
                exec_cycles=exec_cycles,
                dma_overlap=self.cluster.dma_overlap,
                dma_buffers=self._dma.n_buffers,
            )
            timeline.add_trace(c, trace)
            traces.append(trace)
        return ScheduleResult(cluster_traces=traces, timeline=timeline)


# ---------------------------------------------------------------------------
# Event-driven counterpart of the analytical model (eqs. 4-11)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkloadEstimate:
    cycles: int  # NTX-clock makespan per cluster (all clusters balanced)
    time: float  # seconds at f_ntx
    compute_stall_cycles: int
    buffer_stall_cycles: int
    overlap_efficiency: float


def simulate_workload(
    macs: float,
    bytes_total: float,
    *,
    n_clusters: int = 16,
    f_ntx: float = 1.5e9,
    tiles_per_cluster: int = 64,
    bytes_seq_frac: float = 0.02,
    overlap: bool = True,
) -> WorkloadEstimate:
    """Tile a (macs, bytes) kernel over the cube and simulate the streaming.

    Mirrors ``benchmarks/ntx_model.py``'s ``cluster_time``: compute derated by
    eta_c * eta_net, DMA by eta_d at the vault-capped rate, a
    ``bytes_seq_frac`` head+tail that cannot overlap — but the par-phase
    overlap comes out of the double-buffered pipeline simulation rather than
    an analytic ``max()``.
    """
    macs_c = macs / n_clusters
    bytes_c = bytes_total / n_clusters
    seq_bytes = bytes_c * bytes_seq_frac
    par_bytes = bytes_c - seq_bytes

    cfg = dma_mod.DmaConfig().capped(n_clusters, f_ntx)
    # one balanced tile stream per cluster; compute wall-cycles spread over
    # the 8 engines at 1 MAC/cycle each (R_c = 8 MACs/cycle/cluster)
    compute_per_tile = macs_c / tiles_per_cluster / ENGINES_PER_CLUSTER
    compute_per_tile /= ETA_COMPUTE * ETA_NET
    tiles = [
        (dma_mod.Transfer(par_bytes / tiles_per_cluster), compute_per_tile)
        for _ in range(tiles_per_cluster)
    ]
    stats = dma_mod.DmaEngine(cfg).pipeline(tiles, overlap=overlap)
    seq_cycles = int(math.ceil(seq_bytes / (cfg.bytes_per_cycle * cfg.eta)))
    cycles = stats.total_cycles + seq_cycles
    return WorkloadEstimate(
        cycles=cycles,
        time=cycles / f_ntx,
        compute_stall_cycles=stats.compute_stall_cycles,
        buffer_stall_cycles=stats.buffer_stall_cycles,
        overlap_efficiency=stats.overlap_efficiency,
    )
