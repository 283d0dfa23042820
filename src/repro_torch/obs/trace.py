"""Merged Perfetto traces: cluster lanes + link lanes + host spans.

Counterpart of ``repro/obs/trace.py``.
:class:`repro_torch.runtime.scheduler.Timeline`
exports per-command cluster lanes; this module widens the picture to the
whole step in ONE chrome-trace JSON that Perfetto (https://ui.perfetto.dev)
or ``chrome://tracing`` loads directly:

  * **cluster lanes** (``pid hmc0``) — per-cluster exec and DMA spans at
    *block* granularity, reconstructed from the timing engine's per-command
    records by replaying the scheduler's round-robin deal
    (:func:`block_spans`), so every span carries its lowering tag
    (``c1:fwd``, ``spill:act1``, ...).
  * **mesh link lanes** (``pid mesh``) — one track per directed link of
    the HMC mesh, spans from a :class:`~repro_torch.runtime.mesh.LinkSchedule`
    (:meth:`TraceCollector.add_link_lanes`; :meth:`TraceCollector.add_mesh_step`
    renders a sharded step's lead cube and its weight exchange).
  * **host lanes** (``pid host``) — wall-clock spans for graph lowering
    (``lower:{node}:{pass}``) and the torch executor's plan calls, recorded
    live via :meth:`TraceCollector.host_span`. A plan-call span ends when
    the call returns, without a device synchronise: it times the host's
    dispatch of the kernels, not their run on the card.
  * **recovery lanes** (``pid recovery``) — one track per survived cube
    kill: detect, restore and replay spans of the modeled recovery
    (:meth:`TraceCollector.add_recovery`, called by the chaos controller).
  * **flow events** (``ph s/t/f``) — arrows tying a command block's host
    lowering span to its execution span and, for the allreduce epilogue,
    on to the link transfer that carries it.

Simulated lanes are in microseconds of modeled time (cycles / f_ntx, the
NTX cycle model's, not a time on any chip); host lanes are microseconds of
wall time rebased to zero. The groups share the trace, not a clock —
Perfetto renders them as separate process tracks.

Activation mirrors :mod:`repro_torch.obs.counters`: instrument sites check
:func:`get_active_trace` (one global read) and do nothing when no collector
is installed.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager

#: Process-wide active collector (None = trace capture off).
_ACTIVE: "TraceCollector | None" = None


def get_active_trace() -> "TraceCollector | None":
    """The currently installed collector, or None when capture is off."""
    return _ACTIVE


@contextmanager
def use_collector(col: "TraceCollector | None"):
    """Install ``col`` as the process-wide trace collector for the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = col
    try:
        yield col
    finally:
        _ACTIVE = prev


def block_spans(program, result, n_clusters: int):
    """Per-cluster block-granularity spans from a ScheduleResult's records.

    Replays the scheduler's round-robin deal — global command ``i`` lands on
    cluster ``i % n_clusters`` — which holds for both the event engine (flat
    deal in ``MultiClusterScheduler.schedule``) and the block engine
    (``program_segments`` reproduces the same shares, and
    ``simulate_offload_blocks`` materializes records in segment order). Each
    block's span on a cluster runs from its first record's issue to its last
    record's retire. Yields ``(cluster, tag, exec_t0, exec_t1, dma_t0,
    dma_t1, n_cmds)`` in cycles; blocks whose records were elided past the
    block engine's record cap are skipped (their cycles still count — only
    the per-span rendering is lost).
    """
    blocks = list(program.blocks)
    for c, trace in enumerate(result.cluster_traces):
        records = trace.records
        ri = 0
        g = 0
        for b in blocks:
            count = b.n_commands
            first = g + ((c - g) % n_clusters)
            share = (
                (g + count - 1 - first) // n_clusters + 1
                if first < g + count
                else 0
            )
            g += count
            if share == 0:
                continue
            take = records[ri : ri + share]
            ri += share
            if not take:
                continue  # elided tail
            exec_t0 = min(r.program_start for r in take)
            exec_t1 = max(r.retire_t for r in take)
            dma_t0 = min(r.dma_start for r in take)
            dma_t1 = max(r.dma_end for r in take)
            yield (c, b.tag, exec_t0, exec_t1, dma_t0, dma_t1, len(take))


class TraceCollector:
    """Accumulates chrome-trace events from every layer of the stack."""

    def __init__(self, f_ntx: float = 1.5e9):
        self.f_ntx = f_ntx
        self.events: list[dict] = []
        self._host_origin: float | None = None
        self._flow_id = 0

    # -- host (wall-clock) spans --------------------------------------------

    def _now_us(self) -> float:
        t = time.perf_counter()
        if self._host_origin is None:
            self._host_origin = t
        return (t - self._host_origin) * 1e6

    @contextmanager
    def host_span(self, name: str, *, tid: str = "dispatch",
                  cat: str = "host", args: dict | None = None):
        """Record a wall-clock span on the ``host`` process track."""
        t0 = self._now_us()
        try:
            yield
        finally:
            t1 = self._now_us()
            self.events.append({
                "name": name, "cat": cat, "ph": "X",
                "pid": "host", "tid": tid,
                "ts": t0, "dur": max(t1 - t0, 0.01),
                "args": dict(args or {}),
            })

    # -- simulated lanes ----------------------------------------------------

    def _cycles_us(self, cycles: float) -> float:
        return cycles / self.f_ntx * 1e6

    def add_cluster_lanes(self, program, result, n_clusters: int,
                          *, pid: str = "hmc0") -> list[dict]:
        """Block-granularity exec + DMA lanes for one timed program.

        Returns the exec events added (flow-linking anchors).
        """
        exec_events = []
        for c, tag, e0, e1, d0, d1, n in block_spans(program, result, n_clusters):
            name = tag or "untagged"
            ev = {
                "name": name, "cat": "exec", "ph": "X",
                "pid": pid, "tid": f"cluster{c}",
                "ts": self._cycles_us(e0),
                "dur": max(self._cycles_us(e1 - e0), 0.001),
                "args": {"tag": tag, "cycles": e1 - e0, "commands": n},
            }
            self.events.append(ev)
            exec_events.append(ev)
            if d1 > d0:
                self.events.append({
                    "name": name, "cat": "dma", "ph": "X",
                    "pid": pid, "tid": f"cluster{c}:dma",
                    "ts": self._cycles_us(d0),
                    "dur": max(self._cycles_us(d1 - d0), 0.001),
                    "args": {"tag": tag, "cycles": d1 - d0},
                })
        return exec_events

    def add_link_lanes(self, schedule, *, pid: str = "mesh") -> list[dict]:
        """One track per directed mesh link; spans from a LinkSchedule."""
        out = []
        for st in schedule.transfers:
            (a, b) = st.transfer.link
            ev = {
                "name": st.transfer.tag or "transfer", "cat": "link", "ph": "X",
                "pid": pid, "tid": f"{a}->{b}",
                "ts": st.t0 * 1e6,
                "dur": max((st.t1 - st.t0) * 1e6, 0.001),
                "args": {
                    "bytes": st.transfer.num_bytes,
                    "queued_us": st.queued * 1e6,
                },
            }
            self.events.append(ev)
            out.append(ev)
        return out

    # -- flow events --------------------------------------------------------

    def add_flow(self, chain: list[dict], *, name: str = "flow") -> None:
        """Tie already-added "X" events together with s/t/f flow arrows."""
        chain = [ev for ev in chain if ev is not None]
        if len(chain) < 2:
            return
        self._flow_id += 1
        for i, ev in enumerate(chain):
            ph = "s" if i == 0 else ("f" if i == len(chain) - 1 else "t")
            flow = {
                "name": name, "cat": "flow", "ph": ph, "id": self._flow_id,
                "pid": ev["pid"], "tid": ev["tid"],
                "ts": ev["ts"] + ev.get("dur", 0) / 2,
            }
            if ph == "f":
                flow["bp"] = "e"
            self.events.append(flow)

    def link_flows(self, exec_events: list[dict],
                   link_events: list[dict]) -> int:
        """Flow arrows: lowering span -> shard exec span -> link transfer.

        Host lowering spans are matched to compute blocks by their
        ``{node}:{pass}`` step key; allreduce/allgather epilogue blocks are
        matched on to the first link transfer of the systolic pass that
        carries them (reduce passes for gradient reduction, broadcast
        passes for the updated weights). An unsharded step passes an empty
        ``link_events``. Returns the number of flows added.
        """
        host_by_key = {}
        for ev in self.events:
            if ev.get("pid") == "host" and ev["name"].startswith("lower:"):
                host_by_key.setdefault(ev["name"][len("lower:"):], ev)
        first_link: dict[str, dict] = {}
        for ev in link_events:
            first_link.setdefault(ev["name"].split(":")[0], ev)

        def pass_link(*tags):
            for t in tags:
                if t in first_link:
                    return first_link[t]
            return next(iter(link_events), None) if link_events else None

        def step_key(inner: str) -> str:
            # "fc:dw:matmul[0]" -> the lowering span's "fc:dw" step key
            return ":".join(inner.split("[")[0].split(":")[:2])

        seen_keys: set[str] = set()
        n_flows = 0
        for ev in exec_events:
            tag = ev["args"].get("tag", "")
            if tag.startswith("allreduce:reduce:"):
                chain = [host_by_key.get(step_key(tag.split(":", 2)[2])), ev,
                         pass_link("reduce_v", "reduce_h")]
            elif tag.startswith("allreduce:update:"):
                chain = [host_by_key.get(step_key(tag.split(":", 2)[2])), ev,
                         pass_link("bcast_h", "bcast_v")]
            elif tag.startswith("allgather:"):
                chain = [ev, pass_link("bcast_v", "bcast_h")]
            else:
                key = ":".join(tag.split(":")[:2])
                if key in seen_keys or key not in host_by_key:
                    continue
                seen_keys.add(key)
                chain = [host_by_key[key], ev]
            before = self._flow_id
            self.add_flow(chain, name=tag.split("[")[0] or "flow")
            n_flows += self._flow_id - before
        return n_flows

    # -- one-call mesh-step merge -------------------------------------------

    def add_mesh_step(self, sharded, *, n_clusters: int = 16,
                      engine: str | None = None):
        """Time the lead cube's shard + the link exchange; add all lanes + flows.

        ``sharded`` is a :class:`repro_torch.lower.mesh.ShardedTrainStep`.
        Uses the event engine when the shard fits under the block-engine
        threshold (complete per-command records -> complete block spans);
        above it the block engine's record cap trims the rendered tail.
        Returns ``(ScheduleResult, LinkSchedule)``.
        """
        from repro_torch.runtime import scheduler as rt_sched
        from repro_torch.runtime.mesh import LinkSchedule, MeshInterconnect

        lead = sharded.alive_hmcs[0]
        shard = sharded.shard_program(lead)
        if engine is None:
            engine = (
                "event"
                if shard.n_commands <= rt_sched.BLOCK_ENGINE_THRESHOLD
                else "block"
            )
        sched = rt_sched.MultiClusterScheduler(
            n_clusters=n_clusters, f_ntx=self.f_ntx
        )
        result = sched.schedule_program(shard, engine=engine)
        rows, cols = sharded.mesh_shape
        exec_events = self.add_cluster_lanes(
            shard, result, n_clusters, pid=f"hmc{lead}"
        )
        if sharded.n_alive > 1:
            # degraded meshes exchange over the hole-routing survivor ring
            net = MeshInterconnect(rows, cols, failed=sharded.failed_hmcs)
            upd = (net.ring_allreduce(sharded.allreduce_bytes)
                   if sharded.failed_hmcs
                   else net.systolic_update(sharded.allreduce_bytes))
        else:
            upd = LinkSchedule()
        link_events = self.add_link_lanes(upd)
        self.link_flows(exec_events, link_events)
        return result, upd

    def add_recovery(self, step, event, rec, degraded) -> None:
        """Detect -> restore -> replay spans for one survived fault.

        ``event`` is the :class:`repro_torch.runtime.faults.FaultEvent`,
        ``rec`` its :class:`~repro_torch.runtime.faults.RecoveryTiming`,
        ``degraded`` the re-sharded step. Rendered on a dedicated
        ``recovery`` process so the cost sits next to the steady-state
        lanes in the same trace.
        """
        t0 = 0.0
        spans = (
            (f"detect:{event.describe()}", rec.t_detect),
            ("restore:params", rec.t_restore),
            (f"replay:step{step}", rec.t_replay),
        )
        for name, dt in spans:
            self.events.append({
                "name": name, "cat": "recovery", "ph": "X",
                "pid": "recovery", "tid": f"step{step}",
                "ts": t0 * 1e6, "dur": max(dt * 1e6, 0.001),
                "args": {
                    "alive": degraded.n_alive,
                    "failed": list(degraded.failed_hmcs),
                    "recovery_cycles": rec.cycles(self.f_ntx),
                },
            })
            t0 += dt

    # -- export -------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ns"}

    def save(self, path) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return str(path)
