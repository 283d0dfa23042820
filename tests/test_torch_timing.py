"""``repro_torch.lower.run_timing`` against the JAX package's ``run_timing``.

The port's timing model must give the JAX package's cycle counts exactly,
on both engines: for whole paper-CNN step programs, for one lowered layer
per pass at both design points, for a partitioned program, and for random
block-segment streams (the block-replicated engine against the event
engine, as the JAX package's own test holds them). At the main path's
shape (batch 64, img 32, 16 clusters) the figures are held against
constants, the JAX package's output for the same program. Every check
compares stats, never wall-clock ratios.
"""

import dataclasses

import numpy as np
import pytest

from repro import lower as J
from repro.core import ntx as j_ntx
from repro.runtime import cmdqueue as j_cmdqueue
from repro.runtime import scheduler as j_scheduler
from repro_torch.core import ntx
from repro_torch.core.ntx import Agu, NtxCommand
from repro_torch.lower import (
    NS_DESIGN,
    NTX_DESIGN,
    Conv2dSpec,
    MatmulSpec,
    MaxPool2dSpec,
    ReluSpec,
    lower,
    lower_layer,
    lower_training_step,
    paper_cnn_graph,
    run_timing,
)
from repro_torch.obs import program_totals
from repro_torch.runtime import cmdqueue, scheduler
from repro_torch.runtime.cmdqueue import BlockSegment

# The JAX package's lower_training_step + run_timing(n_clusters=16) of the
# paper-CNN step at batch 64, img 32: NTX cycle-model outputs, not times.
MAIN_TOTALS = {"offloads": 10_847, "staging_offloads": 759, "commands": 11_606,
               "busy_cycles": 106_731_647, "dma_bytes": 77_215_656}
MAIN_SUMMARY = {"clusters": 16, "total_cycles": 2_420_531, "queue_depth": 4,
                "n_commands": 11_606, "dma_stall_cycles": 5_212_941,
                "queue_stall_cycles": 22_654_386, "overhead_cycles": 7_558_537}
MAIN_UTILIZATION = 0.34449
# records past the block engine's cap of 50,000 records are not materialised
# on the block engine; the event engine materialises all of them
MAIN_ELIDED = {"event": 0, "block": 3_472}


def _jax_spec(spec):
    from repro.lower import rules as j_rules

    return getattr(j_rules, type(spec).__name__)(**dataclasses.asdict(spec))


@pytest.mark.parametrize("engine", ["event", "block"])
@pytest.mark.parametrize("batch,img", [(2, 8), (4, 16)])
def test_step_program_timing_matches_jax(batch, img, engine):
    prog = lower_training_step(paper_cnn_graph(batch=batch, img=img))
    want_prog = J.lower_training_step(J.paper_cnn_graph(batch=batch, img=img))
    assert prog.summary() == want_prog.summary()
    for n_clusters in (1, 16):
        got = run_timing(prog, n_clusters=n_clusters, engine=engine)
        want = J.run_timing(want_prog, n_clusters=n_clusters, engine=engine)
        assert got.summary() == want.summary(), (n_clusters, got.summary(), want.summary())
        assert got.exec_cycles == want.exec_cycles
        assert [dataclasses.asdict(t.stats) for t in got.cluster_traces] == [
            dataclasses.asdict(t.stats) for t in want.cluster_traces]


LAYERS = [MatmulSpec(30, 20, 10), Conv2dSpec(8, 8, 3, 3, 3, 4, padding=1),
          Conv2dSpec(9, 11, 2, 5, 4, 3, stride=3, padding=2), MaxPool2dSpec(8, 8, 3),
          ReluSpec((6, 5))]


@pytest.mark.parametrize("design", [NTX_DESIGN, NS_DESIGN], ids=["ntx", "ns"])
@pytest.mark.parametrize("spec", LAYERS, ids=[type(s).__name__ + str(i)
                                             for i, s in enumerate(LAYERS)])
def test_layer_program_timing_matches_jax(spec, design):
    jdesign = J.NS_DESIGN if design is NS_DESIGN else J.NTX_DESIGN
    want_progs = J.lower_layer(_jax_spec(spec), design=jdesign)
    progs = lower_layer(spec, design=design)
    assert set(progs) == set(want_progs)
    for pass_, prog in progs.items():
        want_prog = want_progs[pass_]
        assert prog.summary() == want_prog.summary()
        for engine in ("event", "block"):
            got = run_timing(prog, n_clusters=2, engine=engine)
            want = J.run_timing(want_prog, n_clusters=2, engine=engine)
            assert got.summary() == want.summary(), (pass_, engine)


def test_partitioned_and_sync_program_timing_matches_jax():
    spec = Conv2dSpec(12, 12, 4, 3, 3, 8, padding=1)
    part = scheduler.partition_program(lower(spec, "fwd"), 16)
    want_part = j_scheduler.partition_program(J.lower(_jax_spec(spec), "fwd"), 16)
    assert part.n_commands > lower(spec, "fwd").n_commands
    sync = scheduler.ClusterConfig(sync=True)
    j_sync = j_scheduler.ClusterConfig(sync=True)
    for engine in ("event", "block"):
        got = run_timing(part, n_clusters=2, engine=engine)
        assert got.summary() == J.run_timing(want_part, n_clusters=2, engine=engine).summary()
        got = run_timing(part, n_clusters=2, cluster=sync, engine=engine)
        want = J.run_timing(want_part, n_clusters=2, cluster=j_sync, engine=engine)
        assert got.summary() == want.summary()
    with pytest.raises(ValueError, match="unknown timing engine"):
        run_timing(part, engine="fast")


def _rand_template(rng, ntx_mod):
    loops = tuple(int(rng.randint(1, 6)) for _ in range(5))
    return ntx_mod.NtxCommand(
        loops=loops, opcode="mac",
        agu_rd0=ntx_mod.Agu(0, (1, 0, 0, 0, 0)),
        agu_rd1=ntx_mod.Agu(100, (1, 0, 0, 0, 0)) if rng.rand() < 0.7 else None,
        agu_wr=ntx_mod.Agu(200, (0, 1, 0, 0, 0)) if rng.rand() < 0.8 else None,
    )


@pytest.mark.parametrize("seed", range(4))
def test_random_segments_block_engine_matches_event_and_jax(seed):
    """As the JAX package's test_timing_fast.py: random segment streams on
    every config axis, the block engine's stats equal to the event engine's
    on the expanded stream, and both equal to the JAX package's."""
    rng = np.random.RandomState(seed)
    for _ in range(4):
        specs = [(rng.randint(0, 2**31), int(rng.randint(1, 300)),
                  int(rng.choice([0, 3, 17, 80]))) for _ in range(rng.randint(1, 6))]
        segs = [BlockSegment(_rand_template(np.random.RandomState(s), ntx), c, d)
                for s, c, d in specs]
        jsegs = [j_cmdqueue.BlockSegment(_rand_template(np.random.RandomState(s), j_ntx), c, d)
                 for s, c, d in specs]
        cmds = [s.template for s in segs for _ in range(s.count)]
        dcs = [s.dma_cycles for s in segs for _ in range(s.count)]
        kw = dict(
            n_engines=int(rng.choice([1, 3, 8])),
            queue_depth=int(rng.choice([1, 2, 4])),
            sync=bool(rng.rand() < 0.2),
            dma_overlap=bool(rng.rand() < 0.8),
            dma_buffers=int(rng.choice([1, 2, 3])),
        )
        ev = cmdqueue.simulate_offload(cmds, dma_cycles=dcs, **kw)
        bl = cmdqueue.simulate_offload_blocks(segs, **kw)
        assert ev.stats == bl.stats, (kw, ev.stats, bl.stats)
        assert bl.elided_commands + len(bl.records) == len(cmds)
        want = j_cmdqueue.simulate_offload_blocks(jsegs, **kw)
        assert dataclasses.asdict(bl.stats) == dataclasses.asdict(want.stats)
        assert bl.elided_commands == want.elided_commands


def test_block_boundaries_stitch_exactly():
    rng = np.random.RandomState(99)
    segs = [BlockSegment(_rand_template(rng, ntx), c, d)
            for c, d in [(37, 11), (101, 0), (64, 25), (5, 7), (200, 3)]]
    cmds = [s.template for s in segs for _ in range(s.count)]
    dcs = [s.dma_cycles for s in segs for _ in range(s.count)]
    for n_eng in (3, 8):
        ev = cmdqueue.simulate_offload(cmds, n_engines=n_eng, queue_depth=4, dma_cycles=dcs)
        bl = cmdqueue.simulate_offload_blocks(segs, n_engines=n_eng, queue_depth=4)
        assert ev.stats == bl.stats


def test_auto_engine_threshold():
    prog = lower(Conv2dSpec(8, 8, 3, 3, 3, 4, padding=1), "fwd")
    res = run_timing(prog, n_clusters=2)  # below the threshold: every record kept
    assert prog.n_commands <= scheduler.BLOCK_ENGINE_THRESHOLD
    assert sum(len(t.records) for t in res.cluster_traces) == prog.n_commands
    cmd = NtxCommand(loops=(2, 1, 1, 1, 1), opcode="mac", agu_rd0=Agu(0, (1, 0, 0, 0, 0)))
    big = cmdqueue.simulate_offload_blocks([BlockSegment(cmd, 120_000)], max_records=1000)
    assert big.stats.n_commands == 120_000 and len(big.records) <= 1000
    assert big.elided_commands + len(big.records) == 120_000
    jcmd = j_ntx.NtxCommand(loops=(2, 1, 1, 1, 1), opcode="mac",
                            agu_rd0=j_ntx.Agu(0, (1, 0, 0, 0, 0)))
    want = j_cmdqueue.simulate_offload_blocks([j_cmdqueue.BlockSegment(jcmd, 120_000)],
                                              max_records=1000)
    assert dataclasses.asdict(big.stats) == dataclasses.asdict(want.stats)
    assert big.elided_commands == want.elided_commands


@pytest.mark.parametrize("engine", ["block", "event"])
def test_main_path_step_figures(engine):
    """The batch-64 step program through both engines: every figure equal to
    the JAX package's output for the same program (the constants above)."""
    prog = lower_training_step(paper_cnn_graph(batch=64, img=32), n_clusters=16)
    assert program_totals(prog) == MAIN_TOTALS
    res = run_timing(prog, n_clusters=16, engine=engine)
    s = res.summary()
    assert {k: s[k] for k in MAIN_SUMMARY} == MAIN_SUMMARY
    assert s["elided_commands"] == MAIN_ELIDED[engine]
    assert res.exec_cycles == MAIN_TOTALS["busy_cycles"]
    assert round(s["utilization"], 5) == MAIN_UTILIZATION
