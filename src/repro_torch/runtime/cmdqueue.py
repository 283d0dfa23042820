"""Per-co-processor command queues: the loosely-coupled offload path (§2.2).

Counterpart of ``repro/runtime/cmdqueue.py``; the two must give the same
cycle counts for the same command stream (``tests/test_torch_runtime.py``,
``tests/test_torch_timing.py``).

The paper's headline mechanism is that the RISC-V driver core and the NTX
co-processors are *loosely coupled*: the driver writes the next command into a
staging area while the co-processor is still streaming the previous one, so
the per-offload programming cost disappears behind execution and one scalar
core keeps 8 NTX engines busy. This module is a cycle-level discrete-event
model of exactly that flow:

  * :func:`program_cycles` — how long the driver needs to fill one staging
    area (one 32-bit store per register: loop bounds, AGU bases + strides,
    opcode/config — ~26 cycles for a 3-AGU command).
  * :class:`CommandQueue` — a bounded FIFO of staged commands per engine with
    back-pressure: a full queue stalls the driver until a slot retires.
  * :func:`simulate_offload` — one driver feeding ``n_engines`` queues round
    robin, either ``sync`` (tightly coupled: program, issue, spin until
    retire — the NS baseline) or queued (the NTX path). Every command gets
    issue/retire timestamps; DMA prefetch for a staged command may overlap
    the execution of earlier commands (double buffering at the engine).

All times are NTX-clock cycles. The model is exact for FIFO queues because
commands are issued in program order per engine.
"""

from __future__ import annotations

import bisect
import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

from repro_torch.core.ntx import MAX_LOOPS, NtxCommand

# One 32-bit store per staging-area register (§2.2); the issue itself is one
# more store to the command register. A blocking (NS-style) offload
# additionally pays a completion round trip: raise-event + driver wake/poll.
STAGING_WRITE_CYCLES = 1
CMD_ISSUE_CYCLES = 1
SYNC_ROUNDTRIP_CYCLES = 10


def program_cycles(cmd: NtxCommand) -> int:
    """Driver cycles to fill one staging area for ``cmd``.

    Registers written: 5 loop bounds, per present AGU 1 base + 5 strides,
    opcode/levels config word, and the accumulator init value.
    """
    regs = MAX_LOOPS  # loop bounds
    for agu in (cmd.agu_rd0, cmd.agu_rd1, cmd.agu_wr):
        if agu is not None:
            regs += 1 + MAX_LOOPS
    regs += 2  # opcode + init/store levels word, init value
    return regs * STAGING_WRITE_CYCLES + CMD_ISSUE_CYCLES


class QueueFull(RuntimeError):
    """Raised by :meth:`CommandQueue.push` when the FIFO is at depth."""


@dataclass
class QueueRecord:
    """Lifecycle timestamps of one offloaded command (all in NTX cycles)."""

    cmd: NtxCommand
    engine: int
    program_start: int  # driver begins writing the staging area
    issue_t: int  # command enters the queue
    dma_start: int  # input prefetch begins (== issue_t when no DMA)
    dma_end: int
    exec_start: int  # FMAC datapath starts
    retire_t: int  # last store completes; queue slot frees

    @property
    def queue_wait(self) -> int:
        return self.exec_start - self.issue_t

    @property
    def exec_cycles(self) -> int:
        return self.retire_t - self.exec_start


class CommandQueue:
    """Bounded FIFO of in-flight commands for one engine.

    A command occupies its slot from issue until retire (the staging area
    holds it while it executes). ``free_at`` tells the driver when the next
    push can be issued — this is the back-pressure the driver spins on.
    """

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError("queue depth must be >= 1")
        self.depth = depth
        self.records: list[QueueRecord] = []
        self._issues: list[int] = []  # sorted copies of the record timestamps,
        self._retires: list[int] = []  # so occupancy/free_at are O(log n)

    def occupancy(self, t: int) -> int:
        return bisect.bisect_right(self._issues, t) - bisect.bisect_right(
            self._retires, t
        )

    def free_at(self, t: int) -> int:
        """Earliest time >= t at which a new command may be issued."""
        live = len(self._retires) - bisect.bisect_right(self._retires, t)
        if live < self.depth:
            return t
        # the oldest of the newest `depth` in-flight retires first
        return self._retires[len(self._retires) - self.depth]

    def push(self, record: QueueRecord) -> None:
        if self.occupancy(record.issue_t) >= self.depth:
            raise QueueFull(
                f"engine {record.engine}: queue depth {self.depth} exceeded at "
                f"t={record.issue_t}"
            )
        self.records.append(record)
        bisect.insort(self._issues, record.issue_t)
        bisect.insort(self._retires, record.retire_t)


@dataclass(frozen=True)
class OffloadStats:
    """Aggregate of one :func:`simulate_offload` run."""

    n_commands: int
    n_engines: int
    queue_depth: int
    sync: bool
    total_cycles: int  # makespan: last retire
    exec_cycles: int  # sum of datapath-busy cycles over all commands
    dma_cycles: int  # sum of transfer cycles
    driver_cycles: int  # cycles the driver spent programming/spinning
    dma_stall_cycles: int  # engine ready but waiting on its prefetch
    queue_stall_cycles: int  # driver blocked on a full queue (back-pressure)
    overhead_cycles: int  # makespan minus the busiest engine's pure exec time

    @property
    def overhead_per_offload(self) -> float:
        return self.overhead_cycles / max(self.n_commands, 1)

    @property
    def utilization(self) -> float:
        """Fraction of engine-cycles spent executing."""
        return self.exec_cycles / max(self.n_engines * self.total_cycles, 1)


@dataclass
class OffloadTrace:
    records: list[QueueRecord]
    queues: list[CommandQueue]
    stats: OffloadStats
    # commands whose records were not materialized (block-replicated fast
    # path, or the record cap): the stats still account for every command.
    elided_commands: int = 0


def simulate_offload(
    commands: Sequence[NtxCommand],
    *,
    n_engines: int = 8,
    queue_depth: int = 4,
    sync: bool = False,
    exec_cycles: Callable[[NtxCommand], float] | None = None,
    dma_cycles: Sequence[float] | None = None,
    dma_overlap: bool = True,
    dma_buffers: int = 2,
) -> OffloadTrace:
    """One driver core feeding ``n_engines`` command queues.

    ``sync=True`` models the tightly-coupled NS baseline: the driver programs
    a command, issues it, and spins until it retires (plus a completion round
    trip) before touching the next one — queue depth is irrelevant.

    ``dma_cycles[i]`` is the input-transfer time of command ``i``. With
    ``dma_overlap`` the prefetch may start as soon as the command is staged
    (so it hides behind earlier executions, bounded by ``dma_buffers`` TCDM
    tile buffers per engine); without it the transfer runs back-to-back with
    execution — the no-double-buffering strawman.
    """
    exec_fn = exec_cycles or (lambda c: c.busy_cycles)
    queues = [CommandQueue(1 if sync else queue_depth) for _ in range(n_engines)]
    # per-engine state
    busy_until = [0] * n_engines
    dma_busy_until = [0] * n_engines
    done_exec_ends: list[list[int]] = [[] for _ in range(n_engines)]  # per slot reuse
    records: list[QueueRecord] = []

    t_driver = 0
    driver_busy = 0
    queue_stall = 0
    dma_stall = 0
    exec_total = 0
    dma_total = 0

    for i, cmd in enumerate(commands):
        e = i % n_engines
        q = queues[e]
        # back-pressure: wait for a free slot before writing the staging area
        t_free = q.free_at(t_driver)
        queue_stall += t_free - t_driver
        prog_start = t_free
        prog = program_cycles(cmd)
        issue_t = prog_start + prog
        driver_busy += prog

        dc = int(math.ceil(dma_cycles[i])) if dma_cycles is not None else 0
        if dc:
            if dma_overlap:
                # prefetch may start once staged; the target tile buffer must
                # have been drained by the (j - dma_buffers)-th command.
                j = len(done_exec_ends[e])
                slot_free = (
                    done_exec_ends[e][j - dma_buffers] if j >= dma_buffers else 0
                )
                dma_start = max(issue_t, dma_busy_until[e], slot_free)
            else:
                dma_start = max(issue_t, busy_until[e])
            dma_end = dma_start + dc
            dma_busy_until[e] = dma_end
        else:
            dma_start = dma_end = issue_t

        ready = max(busy_until[e], issue_t)
        exec_start = max(ready, dma_end)
        dma_stall += exec_start - ready
        ec = int(math.ceil(exec_fn(cmd)))
        retire_t = exec_start + ec
        busy_until[e] = retire_t
        done_exec_ends[e].append(retire_t)
        exec_total += ec
        dma_total += dc

        rec = QueueRecord(cmd, e, prog_start, issue_t, dma_start, dma_end,
                          exec_start, retire_t)
        q.push(rec)
        records.append(rec)

        if sync:
            # spin until completion + round trip before the next command
            t_driver = retire_t + SYNC_ROUNDTRIP_CYCLES
            driver_busy += SYNC_ROUNDTRIP_CYCLES
        else:
            t_driver = issue_t

    total = max((r.retire_t for r in records), default=0)
    per_engine_exec = [0] * n_engines
    for r in records:
        per_engine_exec[r.engine] += r.exec_cycles
    overhead = total - max(per_engine_exec, default=0)
    stats = OffloadStats(
        n_commands=len(records),
        n_engines=n_engines,
        queue_depth=1 if sync else queue_depth,
        sync=sync,
        total_cycles=total,
        exec_cycles=exec_total,
        dma_cycles=dma_total,
        driver_cycles=driver_busy,
        dma_stall_cycles=dma_stall,
        queue_stall_cycles=queue_stall,
        overhead_cycles=overhead,
    )
    return OffloadTrace(records=records, queues=queues, stats=stats)


# ---------------------------------------------------------------------------
# Block-replicated steady-state simulation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockSegment:
    """A run of ``count`` timing-identical commands (one CommandBlock's share).

    Every command materialized from a :class:`repro_torch.lower.ir.CommandBlock`
    has the same loop bounds, the same AGU population, and the same
    per-command input-DMA bytes — only the AGU *bases* differ between
    replicas, and no timing quantity (:func:`program_cycles`,
    ``busy_cycles``, transfer cycles) depends on a base. A segment therefore
    describes a block's whole command stream to the timing model without
    materializing it.
    """

    template: NtxCommand
    count: int
    dma_cycles: int = 0


def simulate_offload_blocks(
    segments: Iterable[BlockSegment],
    *,
    n_engines: int = 8,
    queue_depth: int = 4,
    sync: bool = False,
    exec_cycles: Callable[[NtxCommand], float] | None = None,
    dma_overlap: bool = True,
    dma_buffers: int = 2,
    max_records: int = 50_000,
) -> OffloadTrace:
    """Bit-exact :func:`simulate_offload` over block-replicated command runs.

    Each segment is simulated event-by-event only until the queue/DMA
    pipeline reaches **steady state** — one full engine round (``n_engines``
    consecutive commands) advancing every live timestamp by the same delta —
    after which the remaining rounds are replicated analytically. The update
    rules are max-plus (``max()`` and ``+`` of per-segment constants), so a
    uniformly shifted state reproduces a uniformly shifted round exactly:
    the analytic tail is cycle-identical to what event-by-event simulation
    would produce, and segment boundaries stitch on the exact carried state
    (per-engine busy/DMA horizons, tile-buffer and queue-slot history).

    ``exec_cycles`` must not depend on AGU bases (the default —
    ``busy_cycles`` — never does). Stats match :func:`simulate_offload` on
    the expanded stream bit for bit; records are materialized only up to
    ``max_records``, ``elided_commands`` counts the rest, and fast-path
    records carry the segment template rather than rebased AGU bases.

    The per-command update rules below deliberately *duplicate* (rather
    than share) :func:`simulate_offload`'s pipeline step: the two engines
    are kept as independent implementations of the same contract so the
    randomized exact-equality tests in ``tests/test_torch_timing.py`` check
    one against the other instead of one implementation against itself.
    Any behavioural change must be made in both and survives those tests.
    """
    exec_fn = exec_cycles or (lambda c: c.busy_cycles)
    depth = 1 if sync else queue_depth
    n_eng = n_engines
    busy = [0] * n_eng
    dma_busy = [0] * n_eng
    exec_hist = [deque(maxlen=dma_buffers) for _ in range(n_eng)]
    retire_hist = [deque(maxlen=depth) for _ in range(n_eng)]
    queues = [CommandQueue(depth) for _ in range(n_eng)]
    records: list[QueueRecord] = []

    state = {
        "t_driver": 0, "driver_busy": 0, "queue_stall": 0, "dma_stall": 0,
        "exec_total": 0, "dma_total": 0, "n_commands": 0, "elided": 0,
        "max_retire": 0, "i": 0,
    }
    per_engine_exec = [0] * n_eng

    for seg in segments:
        if seg.count <= 0:
            continue
        cmd = seg.template
        prog = program_cycles(cmd)
        ec = int(math.ceil(exec_fn(cmd)))
        dc = int(math.ceil(seg.dma_cycles))
        include_dma = dc > 0

        def step():
            s = state
            e = s["i"] % n_eng
            h = retire_hist[e]
            t_driver = s["t_driver"]
            # queue back-pressure (free_at over the last `depth` retires)
            if len(h) == depth and h[0] > t_driver:
                t_free = h[0]
                s["queue_stall"] += t_free - t_driver
            else:
                t_free = t_driver
            prog_start = t_free
            issue_t = prog_start + prog
            s["driver_busy"] += prog
            if dc:
                if dma_overlap:
                    eh = exec_hist[e]
                    slot_free = eh[0] if len(eh) == dma_buffers else 0
                    dma_start = max(issue_t, dma_busy[e], slot_free)
                else:
                    dma_start = max(issue_t, busy[e])
                dma_end = dma_start + dc
                dma_busy[e] = dma_end
            else:
                dma_start = dma_end = issue_t
            ready = busy[e] if busy[e] > issue_t else issue_t
            exec_start = dma_end if dma_end > ready else ready
            s["dma_stall"] += exec_start - ready
            retire_t = exec_start + ec
            busy[e] = retire_t
            exec_hist[e].append(retire_t)
            h.append(retire_t)
            s["exec_total"] += ec
            s["dma_total"] += dc
            per_engine_exec[e] += ec
            s["n_commands"] += 1
            s["i"] += 1
            if retire_t > s["max_retire"]:
                s["max_retire"] = retire_t
            if len(records) < max_records:
                rec = QueueRecord(cmd, e, prog_start, issue_t, dma_start,
                                  dma_end, exec_start, retire_t)
                queues[e].push(rec)
                records.append(rec)
            else:
                s["elided"] += 1
            if sync:
                s["t_driver"] = retire_t + SYNC_ROUNDTRIP_CYCLES
                s["driver_busy"] += SYNC_ROUNDTRIP_CYCLES
            else:
                s["t_driver"] = issue_t

        def signature():
            sig = [state["t_driver"]]
            sig += busy
            if include_dma:
                sig += dma_busy
            for h in exec_hist:
                sig.extend(h)
            for h in retire_hist:
                sig.extend(h)
            return sig

        remaining = seg.count
        prev_sig = None
        qs_mark, ds_mark = state["queue_stall"], state["dma_stall"]
        qs_round = ds_round = 0
        steady = False
        delta = 0
        while remaining >= n_eng:
            for _ in range(n_eng):
                step()
            remaining -= n_eng
            qs_round = state["queue_stall"] - qs_mark
            ds_round = state["dma_stall"] - ds_mark
            qs_mark, ds_mark = state["queue_stall"], state["dma_stall"]
            sig = signature()
            if prev_sig is not None and len(sig) == len(prev_sig):
                delta = sig[0] - prev_sig[0]
                if delta > 0 and all(
                    a - b == delta for a, b in zip(sig, prev_sig)
                ):
                    steady = True
                    break
            prev_sig = sig

        if steady and remaining >= n_eng:
            rounds = remaining // n_eng
            remaining -= rounds * n_eng
            shift = rounds * delta
            state["t_driver"] += shift
            state["max_retire"] = max(
                state["max_retire"], max(busy) + shift
            )
            state["queue_stall"] += rounds * qs_round
            state["dma_stall"] += rounds * ds_round
            state["driver_busy"] += rounds * n_eng * (
                prog + (SYNC_ROUNDTRIP_CYCLES if sync else 0)
            )
            state["exec_total"] += rounds * n_eng * ec
            state["dma_total"] += rounds * n_eng * dc
            state["n_commands"] += rounds * n_eng
            state["elided"] += rounds * n_eng
            state["i"] += rounds * n_eng
            for e in range(n_eng):
                busy[e] += shift
                per_engine_exec[e] += rounds * ec
                if include_dma:
                    dma_busy[e] += shift
                exec_hist[e] = deque(
                    (x + shift for x in exec_hist[e]), maxlen=dma_buffers
                )
                retire_hist[e] = deque(
                    (x + shift for x in retire_hist[e]), maxlen=depth
                )
        while remaining > 0:
            step()
            remaining -= 1

    total = state["max_retire"]
    stats = OffloadStats(
        n_commands=state["n_commands"],
        n_engines=n_eng,
        queue_depth=depth,
        sync=sync,
        total_cycles=total,
        exec_cycles=state["exec_total"],
        dma_cycles=state["dma_total"],
        driver_cycles=state["driver_busy"],
        dma_stall_cycles=state["dma_stall"],
        queue_stall_cycles=state["queue_stall"],
        overhead_cycles=total - max(per_engine_exec, default=0),
    )
    return OffloadTrace(records=records, queues=queues, stats=stats,
                        elided_commands=state["elided"])


def overhead_reduction(
    commands: Sequence[NtxCommand],
    *,
    n_engines: int = 8,
    queue_depth: int = 4,
    **kw,
) -> tuple[OffloadTrace, OffloadTrace, float]:
    """(sync_trace, queued_trace, offload-overhead reduction factor).

    The paper's §2.2 claim: loose coupling cuts the offload overhead — the
    cycles the engines are *not* executing while work remains — by ~7x.
    """
    s = simulate_offload(commands, n_engines=n_engines, sync=True, **kw)
    a = simulate_offload(commands, n_engines=n_engines, queue_depth=queue_depth, **kw)
    red = s.stats.overhead_cycles / max(a.stats.overhead_cycles, 1)
    return s, a, red
