"""The port's offload runtime (``repro_torch.runtime``) against the JAX package's.

The timing model is host arithmetic on integers, so the port must give the
JAX package's numbers exactly: the DMA pipeline field for field, the
command queue's back-pressure, ``simulate_offload`` on matmul command
streams (sync and queued), the overhead reduction (at least 5x, as the
JAX test holds it), loop-nest partitioning command for command,
``simulate_workload`` (the JAX tests hold it within 10 % of the analytic
model, so equality carries that over) and the streaming kernel's tile
stream played through the DMA engine.
"""

import dataclasses

import numpy as np
import pytest

from repro.kernels import streaming as j_streaming
from repro.lower import rules as j_rules
from repro.runtime import cmdqueue as j_cmdqueue
from repro.runtime import dma as j_dma
from repro.runtime import scheduler as j_scheduler
from repro_torch.core import ntx
from repro_torch.kernels import streaming
from repro_torch.lower import rules
from repro_torch.runtime import cmdqueue, dma, scheduler
from repro_torch.runtime.cmdqueue import CommandQueue, QueueFull, QueueRecord


def _cmds(n, m=4, k=16, mod=rules):
    return [mod.matmul_template(m, m, k, 0, 100, 300) for _ in range(n)]


def _astuple(cmd):
    """A command as plain tuples, comparable across the two packages."""
    def agu(a):
        return None if a is None else (a.base, tuple(a.strides))
    return (tuple(cmd.loops), cmd.opcode, agu(cmd.agu_rd0), agu(cmd.agu_rd1), agu(cmd.agu_wr),
            cmd.init_level, cmd.store_level, cmd.init_value)


def _stats(stats):
    return dataclasses.asdict(stats)


def test_calibration_constants_match_jax():
    for name in ("R_D_BYTES_PER_CYCLE", "ETA_DMA", "HMC_INTERNAL_BW", "TCDM_BANKS"):
        assert getattr(dma, name) == getattr(j_dma, name), name
    for name in ("ETA_COMPUTE", "ETA_NET", "ENGINES_PER_CLUSTER", "BLOCK_ENGINE_THRESHOLD"):
        assert getattr(scheduler, name) == getattr(j_scheduler, name), name
    for name in ("STAGING_WRITE_CYCLES", "CMD_ISSUE_CYCLES", "SYNC_ROUNDTRIP_CYCLES"):
        assert getattr(cmdqueue, name) == getattr(j_cmdqueue, name), name


@pytest.mark.parametrize("stride", [0, 1, 2, 3, 8, 32, 33, -4, 96])
def test_bank_conflict_factor_matches_jax(stride):
    for banks in (32, 16, 7):
        assert dma.bank_conflict_factor(stride, banks) == j_dma.bank_conflict_factor(stride, banks)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
@pytest.mark.parametrize("n_buffers", [1, 2, 3])
def test_dma_pipeline_matches_jax(overlap, n_buffers):
    rng = np.random.RandomState(n_buffers)
    raw = [(float(rng.randint(1, 4000)), int(rng.choice([1, 2, 4, 32])), float(rng.rand() * 900))
           for _ in range(40)]
    cfg = dma.DmaConfig(n_buffers=n_buffers).capped(16, 1.5e9)
    jcfg = j_dma.DmaConfig(n_buffers=n_buffers).capped(16, 1.5e9)
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    got = dma.DmaEngine(cfg).pipeline(
        [(dma.Transfer(b, s), c) for b, s, c in raw], overlap=overlap)
    want = j_dma.DmaEngine(jcfg).pipeline(
        [(j_dma.Transfer(b, s), c) for b, s, c in raw], overlap=overlap)
    assert _stats(got) == _stats(want)
    assert got.overlap_efficiency == want.overlap_efficiency
    assert dma.vault_bytes_per_cycle(32, 1.5e9) == j_dma.vault_bytes_per_cycle(32, 1.5e9)


def test_double_buffering_overlaps():
    cfg = dma.DmaConfig(bytes_per_cycle=4.0, eta=1.0)
    tiles = [(dma.Transfer(400), 100)] * 16  # 100 dma cycles vs 100 compute
    ov = dma.DmaEngine(cfg).pipeline(tiles, overlap=True)
    ser = dma.DmaEngine(cfg).pipeline(tiles, overlap=False)
    assert ser.total_cycles == 16 * 200
    assert ov.total_cycles == 100 + 16 * 100  # fill + fully overlapped


# ---------------------------------------------------------------------------
# CommandQueue and simulate_offload
# ---------------------------------------------------------------------------


def _rec(engine, issue, retire):
    return QueueRecord(_cmds(1)[0], engine, issue, issue, issue, issue, issue, retire)


def test_queue_backpressure_and_queue_full():
    q = CommandQueue(depth=2)
    q.push(_rec(0, 0, 100))
    q.push(_rec(0, 10, 200))
    assert q.free_at(50) == 100 and q.free_at(150) == 150
    assert q.occupancy(50) == 2 and q.occupancy(150) == 1
    with pytest.raises(QueueFull):
        q.push(_rec(0, 20, 300))  # both slots still in flight at t=20
    q.push(_rec(0, 100, 400))  # the first retired at t=100
    with pytest.raises(ValueError):
        CommandQueue(0)


@pytest.mark.parametrize("sync", [False, True], ids=["queued", "sync"])
@pytest.mark.parametrize("n_engines,depth,with_dma", [(1, 4, False), (8, 4, False),
                                                       (2, 2, True), (3, 1, True)])
def test_simulate_offload_matches_jax(sync, n_engines, depth, with_dma):
    rng = np.random.RandomState(n_engines * 10 + depth)
    shapes = [(int(rng.randint(2, 9)), int(rng.randint(4, 33))) for _ in range(48)]
    cmds = [rules.matmul_template(m, m, k, 0, 100, 300) for m, k in shapes]
    jcmds = [j_rules.matmul_template(m, m, k, 0, 100, 300) for m, k in shapes]
    dcs = [float(rng.randint(0, 120)) for _ in shapes] if with_dma else None
    kw = dict(n_engines=n_engines, queue_depth=depth, sync=sync, dma_cycles=dcs)
    got = cmdqueue.simulate_offload(cmds, **kw)
    want = j_cmdqueue.simulate_offload(jcmds, **kw)
    assert _stats(got.stats) == _stats(want.stats)
    assert [(r.engine, r.program_start, r.issue_t, r.dma_start, r.dma_end, r.exec_start,
             r.retire_t) for r in got.records] == [
        (r.engine, r.program_start, r.issue_t, r.dma_start, r.dma_end, r.exec_start,
         r.retire_t) for r in want.records]
    assert [cmdqueue.program_cycles(c) for c in cmds] == [
        j_cmdqueue.program_cycles(c) for c in jcmds]
    for q in got.queues:  # no queue ever above its depth
        for r in q.records:
            assert q.occupancy(r.issue_t) <= q.depth


def test_overhead_reduction_matches_jax_and_is_at_least_5x():
    _, _, red = cmdqueue.overhead_reduction(_cmds(128), n_engines=1, queue_depth=4)
    _, _, j_red = j_cmdqueue.overhead_reduction(_cmds(128, mod=j_rules), n_engines=1,
                                                queue_depth=4)
    assert red == j_red
    assert red >= 5.0, red


# ---------------------------------------------------------------------------
# Scheduler: partitioning and the analytic-model counterpart
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parts", [1, 2, 3, 7, 12])
def test_partition_command_matches_jax(parts):
    cmd = rules.matmul_template(7, 5, 6, 0, 100, 300)
    jcmd = j_rules.matmul_template(7, 5, 6, 0, 100, 300)
    got = scheduler.partition_command(cmd, parts)
    want = j_scheduler.partition_command(jcmd, parts)
    assert [_astuple(c) for c in got] == [_astuple(c) for c in want]


def test_partition_refuses_split_accumulations():
    cmd = ntx.NtxCommand(
        loops=(64, 1, 1, 1, 1), opcode="mac",
        agu_rd0=ntx.Agu(0, (1, 0, 0, 0, 0)),
        agu_rd1=ntx.Agu(64, (1, 0, 0, 0, 0)),
        agu_wr=ntx.Agu(200, (0, 0, 0, 0, 0)),
        init_level=ntx.MAX_LOOPS, store_level=5,
    )
    with pytest.raises(ValueError, match="accumulator spans"):
        scheduler.partition_command(cmd, 4)


def test_partition_program_matches_jax():
    from repro.lower import lower as j_lower
    from repro_torch.lower import Conv2dSpec, lower

    prog = scheduler.partition_program(lower(Conv2dSpec(12, 12, 4, 3, 3, 8, padding=1), "fwd"), 16)
    want = j_scheduler.partition_program(
        j_lower(j_rules.Conv2dSpec(12, 12, 4, 3, 3, 8, padding=1), "fwd"), 16)
    assert prog.name == want.name and prog.meta["partitioned"] == 16
    assert [_astuple(c) for c in prog.commands()] == [_astuple(c) for c in want.commands()]
    assert list(prog.command_dma_bytes()) == list(want.command_dma_bytes())


def test_multicluster_distribute_and_timeline_match_jax():
    cmd = rules.matmul_template(64, 32, 32, 0, 10_000, 20_000)
    jcmd = j_rules.matmul_template(64, 32, 32, 0, 10_000, 20_000)
    sched = scheduler.MultiClusterScheduler(n_clusters=4)
    jsched = j_scheduler.MultiClusterScheduler(n_clusters=4)
    buckets, jbuckets = sched.distribute(cmd), jsched.distribute(jcmd)
    assert [[_astuple(c) for c in b] for b in buckets] == [
        [_astuple(c) for c in b] for b in jbuckets]
    res = sched.schedule(buckets, bytes_per_command=[1024.0] * 4)
    jres = jsched.schedule(jbuckets, bytes_per_command=[1024.0] * 4)
    assert res.summary() == jres.summary()
    assert res.timeline.to_chrome_trace() == jres.timeline.to_chrome_trace()
    flat = scheduler.MultiClusterScheduler(n_clusters=3).schedule(_cmds(12))
    assert [t.stats.n_commands for t in flat.cluster_traces] == [4, 4, 4]


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
@pytest.mark.parametrize("macs,nbytes,n_clusters", [
    (1.5e12, 2.0e9, 16),   # GoogLeNet-like: compute-bound
    (3.6e11, 9.0e9, 16),   # DMA-bound
    (7.2e12, 1.1e10, 32),  # past the vault crossbar's knee
])
def test_simulate_workload_matches_jax(macs, nbytes, n_clusters, overlap):
    got = scheduler.simulate_workload(macs, nbytes, n_clusters=n_clusters, overlap=overlap)
    want = j_scheduler.simulate_workload(macs, nbytes, n_clusters=n_clusters, overlap=overlap)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_workloads_of_the_analytic_model_match_jax():
    """The four workloads the JAX test holds within 10 % of the analytic
    model: equal numbers carry that agreement over to the port."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks import ntx_model as M
    from benchmarks.workloads import WORKLOADS

    for name in ("googlenet", "resnet50", "inception_v3", "alexnet"):
        w = WORKLOADS[name]
        macs, nbytes = w.train_gflop * 1e9 / 2, w.dma_bytes(True)
        got = scheduler.simulate_workload(macs, nbytes, n_clusters=16, f_ntx=1.5e9)
        want = j_scheduler.simulate_workload(macs, nbytes, n_clusters=16, f_ntx=1.5e9)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        m = M.cube(M.Kernel(macs=macs, bytes_total=nbytes), 16, 1.5e9, "28nm")
        assert abs(got.time - m.time) / m.time < 0.10, name


@pytest.mark.parametrize("m,n,k,blocks", [
    (256, 256, 512, (128, 128, 128)),
    (64, 10, 512, None),
    (200, 96, 72, (64, 32, 16)),
])
def test_streaming_tiles_through_the_dma_engine_match_jax(m, n, k, blocks):
    """ROADMAP A4's descriptor check: the port's streaming tile stream
    through the port's DMA engine equals JAX's through JAX's."""
    kw = dict(zip(("block_m", "block_n", "block_k"), blocks)) if blocks else {}
    tiles = streaming.streaming_tiles(m, n, k, **kw)
    jtiles = j_streaming.streaming_tiles(m, n, k, **kw)
    assert tiles == jtiles
    for overlap in (True, False):
        got = dma.DmaEngine(dma.DmaConfig()).pipeline(
            [(dma.Transfer(b), macs / 8) for b, macs in tiles], overlap=overlap)
        want = j_dma.DmaEngine(j_dma.DmaConfig()).pipeline(
            [(j_dma.Transfer(b), macs / 8) for b, macs in jtiles], overlap=overlap)
        assert _stats(got) == _stats(want)
        assert got.dma_cycles == sum(dma.DmaConfig().transfer_cycles(dma.Transfer(b))
                                     for b, _ in tiles)
