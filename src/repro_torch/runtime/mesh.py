"""Inter-HMC interconnect model: the mesh's serial links (paper §4.9;
``repro/runtime/mesh.py``).

One HMC talks to its four neighbours over 60 GB/s serial links; a weight
update crosses the mesh as four directional systolic passes (reduce then
broadcast along each axis), eqs. (14)-(15):

    t_pass   = W / LINK_BW + n_side * HOP_LATENCY                   (14)
    t_update = 4 * t_pass                                           (15)

The link layer is explicit instead of closed-form:

  * :class:`MeshInterconnect` — the RxC mesh of directed links with an
    event-level :meth:`~MeshInterconnect.schedule`: transfers on the same
    link serialize (ring-step congestion), disjoint links run concurrently,
    every hop pays the cube-traversal latency. The systolic update and the
    chunked ring allreduce are both built on it; on a congestion-free
    embedding the systolic pass lands exactly on eq. (14). Failed cubes
    kill their links, and the degraded mesh allreduces over a survivor
    ring that routes around the holes.
  * :func:`time_mesh_step` — one timed mesh training step: the per-HMC
    shard program (from :func:`repro_torch.lower.mesh.shard_training_step`)
    goes through the block-replicated timing engine
    (:meth:`~repro_torch.runtime.scheduler.MultiClusterScheduler.schedule_program`),
    the gradient / weight exchange through the link schedule;
    :func:`time_mesh_step_2d` the GPipe rows of a 2D program.

Everything here is host arithmetic: modeled seconds of the NTX cube and its
links at the paper's calibration, not a time on any chip. Every figure is
the JAX package's float arithmetic in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# §4.9 link calibration (the JAX package's constants; a test pins them to its own)
LINK_BW = 60e9  # B/s per serial link
HOP_LATENCY = 20e-6  # s per cube traversal (conservative)
CUBE_POWER_MESH = 21.0  # W assumed during mesh compute
P_LINKS = 8.0  # W, all four serial links

#: One HMC's DRAM capacity (§2: 4 GB cube) — the budget a workload's
#: whole-step footprint is checked against to decide whether it *needs*
#: model sharding (the 2D bench gates that its big case exceeds this).
HMC_DRAM_BYTES = 4 * 2**30


@dataclass(frozen=True)
class LinkTransfer:
    """One point-to-point transfer over a single mesh link."""

    link: tuple[tuple[int, int], tuple[int, int]]  # ((r, c) -> (r, c))
    num_bytes: float
    start: float = 0.0
    tag: str = ""


@dataclass(frozen=True)
class ScheduledTransfer:
    transfer: LinkTransfer
    t0: float
    t1: float

    @property
    def queued(self) -> float:
        """Time spent waiting for the link (congestion)."""
        return self.t0 - self.transfer.start


@dataclass
class LinkSchedule:
    transfers: list[ScheduledTransfer] = field(default_factory=list)

    @property
    def makespan(self) -> float:
        return max((t.t1 for t in self.transfers), default=0.0)

    @property
    def congestion_time(self) -> float:
        return sum(t.queued for t in self.transfers)


class MeshInterconnect:
    """An RxC mesh of HMCs joined by directed nearest-neighbour links.

    ``failed`` marks dead cubes (flat row-major ids or (r, c) coords): a
    dead cube's serial links die with it, so transfers touching it are
    rejected, the systolic update is unavailable, and the degraded mesh
    falls back to a survivor ring that routes *around* the holes
    (:meth:`ring_allreduce`).
    """

    def __init__(self, rows: int, cols: int, *,
                 link_bw: float = LINK_BW, hop_latency: float = HOP_LATENCY,
                 failed=()):
        if rows < 1 or cols < 1:
            raise ValueError(f"degenerate mesh {rows}x{cols}")
        self.rows = rows
        self.cols = cols
        self.link_bw = link_bw
        self.hop_latency = hop_latency
        self.failed: set[tuple[int, int]] = set()
        for node in failed:
            self.fail(node)

    @property
    def n_hmcs(self) -> int:
        return self.rows * self.cols

    def _coord(self, node) -> tuple[int, int]:
        """Flat row-major cube id -> (r, c); coords pass through."""
        if isinstance(node, tuple):
            return node
        return divmod(int(node), self.cols)

    def fail(self, node) -> None:
        """Mark a cube dead (flat id or (r, c)); its four links die too."""
        r, c = self._coord(node)
        if not (0 <= r < self.rows and 0 <= c < self.cols):
            raise ValueError(f"node {(r, c)} outside {self.rows}x{self.cols}")
        self.failed.add((r, c))

    @property
    def alive_nodes(self) -> list[tuple[int, int]]:
        return [(r, c) for r in range(self.rows) for c in range(self.cols)
                if (r, c) not in self.failed]

    def _check_link(self, link) -> None:
        (r0, c0), (r1, c1) = link
        for r, c in ((r0, c0), (r1, c1)):
            if not (0 <= r < self.rows and 0 <= c < self.cols):
                raise ValueError(f"node {(r, c)} outside {self.rows}x{self.cols}")
            if (r, c) in self.failed:
                raise ValueError(f"link {link} touches failed cube {(r, c)}")
        if abs(r0 - r1) + abs(c0 - c1) != 1:
            raise ValueError(f"{link} is not a nearest-neighbour link")

    def transfer_time(self, num_bytes: float) -> float:
        """Wire time of one transfer on one link, excluding the hop."""
        return num_bytes / self.link_bw

    # -- the event-level link scheduler -------------------------------------

    def schedule(self, transfers: list[LinkTransfer]) -> LinkSchedule:
        """Serialize per link, run links concurrently, charge one hop each.

        Transfers are served per link in submission order once their
        ``start`` time arrives — a transfer finding its link busy queues
        behind the one in flight (ring-step congestion). Completion is
        ``begin + hop_latency + bytes / link_bw`` (cut-through: the hop is
        the first-word latency, the stream follows at the wire rate).
        """
        busy: dict[tuple, float] = {}
        out = LinkSchedule()
        for tr in transfers:
            self._check_link(tr.link)
            t0 = max(tr.start, busy.get(tr.link, 0.0))
            t1 = t0 + self.hop_latency + self.transfer_time(tr.num_bytes)
            busy[tr.link] = t1
            out.transfers.append(ScheduledTransfer(tr, t0, t1))
        return out

    # -- the paper's systolic weight update (eqs. 14-15) ---------------------

    def _pass_transfers(self, num_bytes: float, axis: int, reverse: bool,
                        t0: float, tag: str) -> list[LinkTransfer]:
        """One directional pass: every line of the mesh pipelines the full
        array across its links, cut-through (link ``i`` starts one hop
        after link ``i-1``, streaming concurrently). The last link of a
        length-L line completes at ``t0 + L * hop + bytes / bw`` — eq. (14)
        with that axis's extent as n_side.
        """
        out = []
        n_lines = self.cols if axis == 0 else self.rows
        length = self.rows if axis == 0 else self.cols
        hops = range(length - 1)
        for line in range(n_lines):
            for i, h in enumerate(reversed(hops) if reverse else hops):
                if axis == 0:
                    a, b = (h, line), (h + 1, line)
                else:
                    a, b = (line, h), (line, h + 1)
                if reverse:
                    a, b = b, a
                out.append(LinkTransfer(
                    link=(a, b), num_bytes=num_bytes,
                    start=t0 + (i + 1) * self.hop_latency,
                    tag=f"{tag}:line{line}",
                ))
        return out

    def systolic_update(self, weight_bytes: float) -> LinkSchedule:
        """The 4-pass weight exchange: reduce then broadcast along each
        axis, each pass streaming the full W bytes down every line.

        On the congestion-free line embedding each pass takes
        ``W / link_bw + L * hop_latency`` — eq. (14) with the axis extent
        as n_side — and the passes serialize, so a square mesh lands
        exactly on eq. (15); degenerate axes (extent 1) contribute no
        pass. The schedule is built from individual
        :class:`LinkTransfer`s, so a different embedding (or a busy mesh)
        shows up as congestion, not as a changed formula.
        """
        if self.failed:
            raise ValueError(
                "systolic update needs every line intact; a degraded mesh "
                "allreduces over the survivor ring (ring_allreduce)"
            )
        transfers: list[LinkTransfer] = []
        t0 = 0.0
        for axis, reverse, tag in ((0, False, "reduce_v"), (1, False, "reduce_h"),
                                   (1, True, "bcast_h"), (0, True, "bcast_v")):
            length = self.rows if axis == 0 else self.cols
            if length < 2:
                continue
            transfers += self._pass_transfers(weight_bytes, axis, reverse, t0, tag)
            t0 += self.transfer_time(weight_bytes) + length * self.hop_latency
        return self.schedule(transfers)

    def update_time(self, weight_bytes: float) -> float:
        """The weight-exchange time: eq. (15) systolic on a healthy mesh,
        the survivor-ring allreduce once any cube has failed."""
        if len(self.alive_nodes) <= 1:
            return 0.0
        if self.failed:
            return self.ring_allreduce(weight_bytes).makespan
        return self.systolic_update(weight_bytes).makespan

    # -- the chunked ring alternative ----------------------------------------

    def ring_allreduce(self, num_bytes: float) -> LinkSchedule:
        """Reduce-scatter + allgather over a boustrophedon ring embedding.

        2(n-1) steps, each moving ``num_bytes / n`` per node; the snake
        embedding uses every mesh link at most once per direction, so the
        steps themselves are congestion-free and the schedule time is
        ``2 (n-1) (num_bytes / (n * link_bw) + hop)``.

        On a degraded mesh the ring is the *survivor* snake: dead cubes
        drop out, and ring edges whose snake neighbours are no longer
        adjacent route store-and-forward around the holes (BFS over alive
        cubes) — recovery cost appears as extra hops and congestion, not a
        changed formula.
        """
        nodes = self._snake_nodes()
        n = len(nodes)
        if n <= 1:
            return LinkSchedule()
        chunk = num_bytes / n
        transfers = []
        t0 = 0.0
        step_t = self.transfer_time(chunk) + self.hop_latency
        for step in range(2 * (n - 1)):
            phase = "reduce" if step < n - 1 else "gather"
            for i in range(n):
                a, b = nodes[i], nodes[(i + 1) % n]
                if abs(a[0] - b[0]) + abs(a[1] - b[1]) != 1:
                    # the ring's wrap edge (or a hole the snake skips) is
                    # not a mesh link: route it store-and-forward through
                    # intermediate cubes (hop j starts once hop j-1
                    # delivered). The detour's latency stretches the ring
                    # past the single-hop floor, and on a busy mesh its
                    # links queue like any other transfer.
                    path = self._route_around(a, b)
                    for hop_i, (u, v) in enumerate(zip(path, path[1:])):
                        transfers.append(LinkTransfer(
                            (u, v), chunk,
                            t0 + hop_i * (self.transfer_time(chunk)
                                          + self.hop_latency),
                            f"ring:{phase}{step}",
                        ))
                else:
                    transfers.append(LinkTransfer((a, b), chunk, t0,
                                                  f"ring:{phase}{step}"))
            t0 += step_t
        return self.schedule(transfers)

    def ring_allreduce_time(self, num_bytes: float) -> float:
        return self.ring_allreduce(num_bytes).makespan

    def _snake_nodes(self) -> list[tuple[int, int]]:
        """The boustrophedon ring order, dead cubes skipped."""
        nodes = []
        for r in range(self.rows):
            cs = range(self.cols) if r % 2 == 0 else range(self.cols - 1, -1, -1)
            nodes += [(r, c) for c in cs if (r, c) not in self.failed]
        return nodes

    def _route_around(self, a: tuple[int, int], b: tuple[int, int]
                      ) -> list[tuple[int, int]]:
        """A multi-hop path from ``a`` to ``b`` avoiding failed cubes.

        Dimension-ordered (row-first) when that path is clear — identical
        to the healthy wrap route — else shortest path by BFS over the
        survivors. Raises when the failures partition the mesh.
        """
        path = _route(a, b)
        if not self.failed or all(p not in self.failed for p in path):
            return path
        from collections import deque

        prev: dict[tuple[int, int], tuple[int, int] | None] = {a: None}
        q = deque([a])
        while q:
            u = q.popleft()
            if u == b:
                break
            r, c = u
            for v in ((r + 1, c), (r - 1, c), (r, c + 1), (r, c - 1)):
                if (0 <= v[0] < self.rows and 0 <= v[1] < self.cols
                        and v not in self.failed and v not in prev):
                    prev[v] = u
                    q.append(v)
        if b not in prev:
            raise ValueError(
                f"mesh partitioned: no route {a}->{b} around failed cubes "
                f"{sorted(self.failed)}"
            )
        out = [b]
        while out[-1] != a:
            out.append(prev[out[-1]])
        return out[::-1]


def _route(a: tuple[int, int], b: tuple[int, int]) -> list[tuple[int, int]]:
    """Dimension-ordered (row-first) path between two mesh nodes."""
    path = [a]
    r, c = a
    while r != b[0]:
        r += 1 if b[0] > r else -1
        path.append((r, c))
    while c != b[1]:
        c += 1 if b[1] > c else -1
        path.append((r, c))
    return path


def _partition_coarse(program, parts: int):
    """§3.1 refinement of only the *coarse* blocks of ``program``.

    Blocks with fewer than ``parts`` commands (single-command whole-batch
    relus, spill/fill blits, the reduce-scatter chunks) cannot spread over
    all clusters x engines and would pin one cluster with a multi-second
    command; blocks already streaming thousands of replicas balance on
    their own and are left untouched — full :func:`partition_program`
    would multiply the block count by ``parts`` for no balance gain.
    """
    from repro_torch.lower.ir import NtxProgram
    from repro_torch.lower.mesh import split_block_template

    new_blocks = []
    for b in program.blocks:
        if b.n_commands >= parts:
            new_blocks.append(b)
            continue
        want = -(-parts // b.n_commands)  # ceil: pieces x replicas >= parts
        new_blocks.extend(split_block_template(b, want))
    return NtxProgram(
        name=f"{program.name}:coarse{parts}",
        blocks=new_blocks,
        regions=program.regions,
        design=program.design,
        meta={**program.meta, "partitioned_coarse": parts},
    )


# ---------------------------------------------------------------------------
# One executed + timed mesh training step
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshStepTiming:
    """Timing of one data-parallel training step on a mesh of HMCs."""

    mesh_shape: tuple[int, int]
    n_hmcs: int
    batch: int
    t_shard: float  # s: one cube's shard program (compute + spill DMA)
    t_update: float  # s: the link exchange (eq. 15, or survivor ring)
    t_single: float  # s: the unsharded step on one cube
    shard_cycles: int
    single_cycles: int
    link_congestion: float  # s queued on busy links during the update
    alive_hmcs: int = 0  # surviving cubes; 0 = every cube healthy

    @property
    def n_alive(self) -> int:
        return self.alive_hmcs or self.n_hmcs

    @property
    def t_step(self) -> float:
        return self.t_shard + self.t_update

    @property
    def speedup(self) -> float:
        return self.t_single / self.t_step

    @property
    def parallel_eff(self) -> float:
        """Speedup per *surviving* cube — how well the survivors are used."""
        return self.speedup / self.n_alive

    @property
    def t_image(self) -> float:
        """Per-image time of the single-cube baseline (eq. 16's t_image)."""
        return self.t_single / self.batch

    def summary(self) -> dict:
        return {
            "mesh": f"{self.mesh_shape[0]}x{self.mesh_shape[1]}",
            "n_hmcs": self.n_hmcs,
            "n_alive": self.n_alive,
            "batch": self.batch,
            "t_shard_ms": self.t_shard * 1e3,
            "t_update_ms": self.t_update * 1e3,
            "t_step_ms": self.t_step * 1e3,
            "t_single_ms": self.t_single * 1e3,
            "speedup": self.speedup,
            "parallel_eff": self.parallel_eff,
            "link_congestion_ms": self.link_congestion * 1e3,
        }


def time_mesh_step(
    sharded,
    *,
    n_clusters: int = 16,
    f_ntx: float = 1.5e9,
    derate: bool = True,
    engine: str = "block",
    partition: bool = True,
    single_result=None,
) -> MeshStepTiming:
    """Time one mesh step: shard program on the block engine + link exchange.

    ``sharded`` is a :class:`repro_torch.lower.mesh.ShardedTrainStep`. Every
    cube runs a structurally identical shard, so HMC 0's program stands for all;
    the weight exchange is the eq.-(15) systolic update over the program's
    actual parameter bytes. ``derate=True`` applies the calibrated
    eta_c * eta_net compute derating of the paper's analytical model;
    ``partition=True`` first refines
    both programs with :func:`~repro_torch.runtime.scheduler.partition_program`
    (§3.1 tiling) so single-command blocks — whole-batch relus, spill
    blits — spread over all clusters x engines instead of pinning one
    cluster. ``single_result`` optionally reuses an already-timed unsharded
    ScheduleResult (callers sweeping mesh sizes at a fixed batch share it).

    2D-sharded programs delegate to :func:`time_mesh_step_2d` (GPipe
    fill/drain + per-row exchange), so callers can hand either layout to
    this one entry point.
    """
    if sharded.program.meta.get("mesh", {}).get("shard") == "2d":
        return time_mesh_step_2d(
            sharded, n_clusters=n_clusters, f_ntx=f_ntx, derate=derate,
            engine=engine, partition=partition, single_result=single_result,
        )
    from repro_torch.runtime import scheduler as rt_sched

    eta = rt_sched.ETA_COMPUTE * rt_sched.ETA_NET
    exec_cycles = (lambda c: c.busy_cycles / eta) if derate else None
    parts = n_clusters * rt_sched.ENGINES_PER_CLUSTER

    def timed(program):
        if partition:
            program = _partition_coarse(program, parts)
        sched = rt_sched.MultiClusterScheduler(
            n_clusters=n_clusters, f_ntx=f_ntx
        )
        return sched.schedule_program(program, engine=engine,
                                      exec_cycles=exec_cycles)

    shard_res = timed(sharded.shard_program(sharded.alive_hmcs[0]))
    if single_result is None:
        single_result = timed(sharded.base_program)
    rows, cols = sharded.mesh_shape
    net = MeshInterconnect(rows, cols, failed=sharded.failed_hmcs)
    if sharded.n_alive > 1:
        # a degraded mesh can't run the systolic lines through a dead
        # cube: the survivors fall back to the hole-routing ring
        upd = (net.ring_allreduce(sharded.allreduce_bytes)
               if sharded.failed_hmcs
               else net.systolic_update(sharded.allreduce_bytes))
        t_update, congestion = upd.makespan, upd.congestion_time
        from repro_torch.obs import counters as obs

        obs.record_link_schedule(obs.get_active(), upd)
    else:
        t_update, congestion = 0.0, 0.0
    return MeshStepTiming(
        mesh_shape=sharded.mesh_shape,
        n_hmcs=sharded.n_hmcs,
        batch=sharded.graph.batch,
        t_shard=shard_res.total_cycles / f_ntx,
        t_update=t_update,
        t_single=single_result.total_cycles / f_ntx,
        shard_cycles=shard_res.total_cycles,
        single_cycles=single_result.total_cycles,
        link_congestion=congestion,
        alive_hmcs=sharded.n_alive,
    )


@dataclass(frozen=True)
class MeshStepTiming2D:
    """Timing of one 2D-sharded (pipeline x tensor/data) mesh step.

    Duck-types :class:`MeshStepTiming`'s derived metrics (``t_step`` /
    ``speedup`` / ``parallel_eff`` / ``t_image`` / ``summary``) so the
    training CLI consumes either. ``parallel_eff`` is
    measured against perfect scaling of the interconnect-model baseline:
    ``t_single / (t_step * n_alive)``.
    """

    mesh_shape: tuple[int, int]
    n_hmcs: int
    batch: int
    n_micro: int  # GPipe microbatches in the fill/drain schedule
    row_times: tuple[float, ...]  # s: full-batch shard per pipeline row
    t_compute: float  # s: pipeline makespan (fill + steady + drain)
    t_boundary: float  # s: vertical-link send/recv schedule makespan
    t_update: float  # s: per-row weight exchange (2 passes over row links)
    t_single: float  # s: the unsharded step on one cube
    bubble_frac: float  # idle fraction of total stage-time
    shard_cycles: int  # sum of the per-row representative shard cycles
    single_cycles: int
    link_congestion: float  # s queued on busy links (boundary + update)
    alive_hmcs: int = 0

    @property
    def n_alive(self) -> int:
        return self.alive_hmcs or self.n_hmcs

    @property
    def t_shard(self) -> float:
        """The slowest row's full-batch shard time (bottleneck stage)."""
        return max(self.row_times)

    @property
    def t_step(self) -> float:
        # boundary transfers overlap the fill/drain compute; the weight
        # exchange serializes after the drain, exactly like the 1D model
        return max(self.t_compute, self.t_boundary) + self.t_update

    @property
    def speedup(self) -> float:
        return self.t_single / self.t_step

    @property
    def parallel_eff(self) -> float:
        return self.speedup / self.n_alive

    @property
    def t_image(self) -> float:
        return self.t_single / self.batch

    def summary(self) -> dict:
        return {
            "mesh": f"{self.mesh_shape[0]}x{self.mesh_shape[1]}",
            "n_hmcs": self.n_hmcs,
            "n_alive": self.n_alive,
            "batch": self.batch,
            "n_micro": self.n_micro,
            "row_times_ms": [t * 1e3 for t in self.row_times],
            "t_compute_ms": self.t_compute * 1e3,
            "t_boundary_ms": self.t_boundary * 1e3,
            "t_update_ms": self.t_update * 1e3,
            "t_step_ms": self.t_step * 1e3,
            "t_single_ms": self.t_single * 1e3,
            "bubble_frac": self.bubble_frac,
            "speedup": self.speedup,
            "parallel_eff": self.parallel_eff,
            "link_congestion_ms": self.link_congestion * 1e3,
        }


def _row_update_transfers(
    net: MeshInterconnect, row: int, columns: tuple[int, ...], weight_bytes: float
) -> list[LinkTransfer]:
    """The 2-pass (reduce + broadcast) weight exchange of one pipeline row.

    The row's stage parameters never leave the row, so the exchange is
    eq. (14) along the row's horizontal links only — cut-through down the
    line of *surviving* columns, then back. Consecutive survivors that
    are no longer adjacent (a dead cube inside the tensor group) route
    store-and-forward around the hole, exactly like the degraded ring.
    Different rows use disjoint links, so one schedule over all rows
    overlaps them.
    """
    if len(columns) < 2 or weight_bytes <= 0:
        return []
    coords = [(row, c) for c in columns]
    transfers: list[LinkTransfer] = []
    t0 = 0.0
    for reverse, tag in ((False, "rowreduce"), (True, "rowbcast")):
        hops = list(zip(coords, coords[1:]))
        if reverse:
            hops = [(b, a) for a, b in reversed(hops)]
        i = 0
        for a, b in hops:
            path = net._route_around(a, b)
            for u, v in zip(path, path[1:]):
                transfers.append(LinkTransfer(
                    link=(u, v), num_bytes=weight_bytes,
                    start=t0 + (i + 1) * net.hop_latency,
                    tag=f"{tag}:row{row}",
                ))
                i += 1
        t0 += net.transfer_time(weight_bytes) + (i + 1) * net.hop_latency
    return transfers


def time_mesh_step_2d(
    sharded,
    *,
    n_clusters: int = 16,
    f_ntx: float = 1.5e9,
    derate: bool = True,
    engine: str = "block",
    partition: bool = True,
    single_result=None,
) -> MeshStepTiming2D:
    """Time one 2D-sharded mesh step: GPipe rows + event-level link traffic.

    Per pipeline row the representative surviving cube's shard program is
    timed on the block engine (full batch — every column of a row is
    structurally symmetric, like the 1D model). With per-row full-batch
    times ``t_r`` and ``M`` microbatches, the non-interleaved GPipe
    fill/drain makespan is::

        t_compute = sum_r t_r / M  +  (M - 1) * max_r t_r / M

    (each microbatch visits every stage once — the merged fwd+bwd visit —
    and the steady state is paced by the slowest stage; at R = 1 this
    reduces to the 1D shard time, and for balanced stages the overhead is
    the textbook ``(R - 1) / (M + R - 1)`` bubble). Stage-boundary
    activations/gradients become per-microbatch vertical-link transfers
    (one chunk per column pair, timed by :meth:`MeshInterconnect.schedule`
    — congestion shows up, fwd and bwd use opposite link directions); the
    per-row weight exchange runs 2 passes over each row's horizontal
    links with that *row's* parameter bytes, all rows concurrent.
    """
    from repro_torch.runtime import scheduler as rt_sched

    meta = sharded.program.meta["mesh"]
    pmeta = meta["pipeline"]
    rows, cols = sharded.mesh_shape
    n_micro = int(pmeta["n_micro"])
    row_owners = [tuple(ro) for ro in meta["row_owners"]]

    eta = rt_sched.ETA_COMPUTE * rt_sched.ETA_NET
    exec_cycles = (lambda c: c.busy_cycles / eta) if derate else None
    parts = n_clusters * rt_sched.ENGINES_PER_CLUSTER

    def timed(program):
        if partition:
            program = _partition_coarse(program, parts)
        sched = rt_sched.MultiClusterScheduler(n_clusters=n_clusters, f_ntx=f_ntx)
        return sched.schedule_program(program, engine=engine, exec_cycles=exec_cycles)

    row_results = [timed(sharded.shard_program(ro[0])) for ro in row_owners]
    if single_result is None:
        single_result = timed(sharded.base_program)
    row_times = tuple(res.total_cycles / f_ntx for res in row_results)
    tau = [t / n_micro for t in row_times]
    tau_max = max(tau)
    t_compute = sum(tau) + (n_micro - 1) * tau_max
    bubble_frac = 1.0 - sum(row_times) / (rows * t_compute) if t_compute else 0.0

    net = MeshInterconnect(rows, cols, failed=sharded.failed_hmcs)
    alive = set(sharded.alive_hmcs)

    # stage-boundary traffic: one chunk per (microbatch, column pair) on
    # the vertical links, paced by the steady-state microbatch cadence
    boundary: list[LinkTransfer] = []
    for x in pmeta["xfers"]:
        src, dst = int(x["src"]), int(x["dst"])
        pair_cols = [
            c for c in range(cols)
            if src * cols + c in alive and dst * cols + c in alive
        ]
        if pair_cols:
            chunk = float(x["bytes"]) / (len(pair_cols) * n_micro)
            for m in range(n_micro):
                for c in pair_cols:
                    boundary.append(LinkTransfer(
                        link=((src, c), (dst, c)), num_bytes=chunk,
                        start=m * tau_max, tag=f"pipe:{x['region']}",
                    ))
        else:
            # pathological degradation: no straight column pair survives;
            # route the whole tensor between the rows' first survivors
            a = net._coord(row_owners[src][0])
            b = net._coord(row_owners[dst][0])
            path = net._route_around(a, b)
            chunk = float(x["bytes"]) / n_micro
            for m in range(n_micro):
                for u, v in zip(path, path[1:]):
                    boundary.append(LinkTransfer(
                        link=(u, v), num_bytes=chunk,
                        start=m * tau_max, tag=f"pipe:{x['region']}",
                    ))
    bsched = net.schedule(boundary)

    upd_transfers: list[LinkTransfer] = []
    for r, ro in enumerate(row_owners):
        columns = tuple(net._coord(h)[1] for h in ro)
        upd_transfers += _row_update_transfers(
            net, r, columns, float(pmeta["stage_param_bytes"][r])
        )
    usched = net.schedule(upd_transfers)

    from repro_torch.obs import counters as obs

    reg = obs.get_active()
    obs.record_link_schedule(reg, bsched)
    obs.record_link_schedule(reg, usched)

    return MeshStepTiming2D(
        mesh_shape=sharded.mesh_shape,
        n_hmcs=sharded.n_hmcs,
        batch=sharded.graph.batch,
        n_micro=n_micro,
        row_times=row_times,
        t_compute=t_compute,
        t_boundary=bsched.makespan,
        t_update=usched.makespan,
        t_single=single_result.total_cycles / f_ntx,
        bubble_frac=bubble_frac,
        shard_cycles=sum(res.total_cycles for res in row_results),
        single_cycles=single_result.total_cycles,
        link_congestion=bsched.congestion_time + usched.congestion_time,
        alive_hmcs=sharded.n_alive,
    )


def expected_update_time(weight_bytes: float, rows: int, cols: int) -> float:
    """The closed-form value the link schedule must reproduce.

    Two passes (reduce + broadcast) per non-degenerate axis, each eq. (14)
    with that axis's extent as n_side — on a square mesh exactly eq. (15),
    ``4 (W / LINK_BW + n_side * HOP)``; on a rectangle the shorter axis
    pays its own (smaller) hop count.
    """
    total = 0.0
    for length in (rows, cols):
        if length > 1:
            total += 2.0 * (weight_bytes / LINK_BW + length * HOP_LATENCY)
    return total
