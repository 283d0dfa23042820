"""The mesh of HMCs, host half: the port's splitter and link model vs JAX's.

``repro_torch.lower.mesh`` (``shard_training_step`` 1D and 2D,
``reshard_training_step``) gives the JAX package's programs command block by
command block, the same cube of every block and the same ``meta["mesh"]``;
``repro_torch.runtime.mesh`` (the link schedule, the systolic update and
survivor ring, ``time_mesh_step`` / ``time_mesh_step_2d``) gives its figures
at ``==``: the same float sums in the same order. Errors carry the same
messages. The structure tests are ``tests/test_mesh.py``'s, read on the
port's programs. The telemetry (link counters, the merged trace's mesh
lanes) is held against the schedule and against JAX's collector.

Paper CNN at batch 8, img 8 (batch 64, img 32 for the modeled figures of
the full-width step).
"""

import dataclasses

import numpy as np
import pytest

from repro import obs as j_obs
from repro.lower import NS_DESIGN as J_NS
from repro.lower import lower_training_step as j_lower_training_step
from repro.lower import paper_cnn_graph as j_paper_cnn_graph
from repro.lower import plan_fusion as j_plan_fusion
from repro.lower import reshard_training_step as j_reshard
from repro.lower import shard_training_step as j_shard
from repro.lower.mesh import parse_mesh as j_parse_mesh
from repro.runtime import mesh as j_mesh
from repro_torch import obs
from repro_torch.lower import (
    NS_DESIGN,
    lower_training_step,
    paper_cnn_graph,
    parse_mesh,
    plan_fusion,
    reshard_training_step,
    shard_training_step,
)
from repro_torch.lower.mesh import ALL_HMCS
from repro_torch.runtime import mesh as t_mesh
from repro_torch.runtime.mesh import (
    HOP_LATENCY,
    LINK_BW,
    LinkTransfer,
    MeshInterconnect,
    expected_update_time,
    time_mesh_step,
)
from test_torch_lower import _same_program

MESHES = [(1, 1), (1, 2), (2, 2), (2, 4)]


def _graphs(batch=8, img=8, momentum=0.9):
    return (paper_cnn_graph(batch=batch, img=img, momentum=momentum),
            j_paper_cnn_graph(batch=batch, img=img, momentum=momentum))


def _same_sharded(got, want):
    """Command for command, cube for cube, and the same meta["mesh"]."""
    _same_program(got.program, want.program)
    _same_program(got.base_program, want.base_program)
    assert got.hmc_of_block == want.hmc_of_block
    assert got.program.meta["mesh"] == want.program.meta["mesh"]
    assert (got.mesh_shape, got.alive, got.shard, got.allreduce_bytes) == (
        want.mesh_shape, want.alive, want.shard, want.allreduce_bytes)
    for h in got.alive_hmcs:
        _same_program(got.shard_program(h), want.shard_program(h))


# ---------------------------------------------------------------------------
# Programs: the JAX package's, command for command
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard", ["1d", "2d"])
@pytest.mark.parametrize("mesh", MESHES, ids=[f"{r}x{c}" for r, c in MESHES])
def test_sharded_programs_match_jax(mesh, shard):
    graph, jgraph = _graphs()
    got = shard_training_step(graph, mesh_shape=mesh, shard=shard)
    want = j_shard(jgraph, mesh_shape=mesh, shard=shard)
    _same_sharded(got, want)


@pytest.mark.parametrize("design,momentum,shard", [
    ("ntx", 0.0, "1d"), ("ns", 0.9, "1d"), ("ntx", 0.0, "2d"), ("ns", 0.9, "2d")])
def test_sharded_programs_match_jax_designs(design, momentum, shard):
    """Plain SGD, and the NS design point (every block carries driver reps),
    as the JAX tests parametrise them."""
    graph, jgraph = _graphs(momentum=momentum)
    kw, jkw = ({"design": NS_DESIGN}, {"design": J_NS}) if design == "ns" else ({}, {})
    got = shard_training_step(graph, mesh_shape=(2, 2), shard=shard, **kw)
    want = j_shard(jgraph, mesh_shape=(2, 2), shard=shard, **jkw)
    _same_sharded(got, want)


@pytest.mark.parametrize("shard", ["1d", "2d"])
def test_spilled_program_shards_match_jax(shard):
    """A tiny TCDM budget spills; spill / fill blits split like JAX's."""
    graph, jgraph = _graphs(img=16, momentum=0.9)
    prog = lower_training_step(graph, n_clusters=1)
    assert prog.meta["spilled"]
    got = shard_training_step(graph, mesh_shape=(2, 2), program=prog, n_clusters=1,
                              shard=shard)
    want = j_shard(jgraph, mesh_shape=(2, 2), n_clusters=1, shard=shard)
    _same_sharded(got, want)


@pytest.mark.parametrize("shard,kills,alive", [
    ("1d", (1,), (0, 2, 3)), ("1d", (3, 0), (1, 2)), ("2d", (1,), (0, 2, 3)),
    ("2d", (1, 3), (0, 2))])
def test_reshard_matches_jax(shard, kills, alive):
    """One kill, and two cumulative kills (tests/test_faults.py:136, :151;
    tests/test_mesh.py's 2D tensor-group case)."""
    graph, jgraph = _graphs()
    got = shard_training_step(graph, mesh_shape=(2, 2), shard=shard)
    want = j_shard(jgraph, mesh_shape=(2, 2), shard=shard)
    for h in kills:
        got, want = reshard_training_step(got, h), j_reshard(want, h)
        _same_sharded(got, want)
    assert got.alive_hmcs == alive and got.failed_hmcs == tuple(sorted(kills))


def test_sharded_meta_drops_the_base_programs_memos():
    """A program's plan and command-table memos describe its own blocks, so
    the sharded program does not inherit them."""
    graph, _ = _graphs()
    prog = lower_training_step(graph)
    prog.meta["_fusion_plans"] = {True: plan_fusion(prog)}
    prog.meta["_ntx_exec"] = {}
    sh = shard_training_step(graph, mesh_shape=(2, 2), program=prog)
    assert not any(k.startswith("_") for k in sh.program.meta)
    assert not any(k.startswith("_") for k in sh.shard_program(0).meta)
    assert {k for k in prog.meta if not k.startswith("_")} | {"mesh"} == set(sh.program.meta)


# ---------------------------------------------------------------------------
# Structure (tests/test_mesh.py, read on the port's programs)
# ---------------------------------------------------------------------------


def test_allreduce_epilogue_structure():
    graph, _ = _graphs()
    sh = shard_training_step(graph, mesh_shape=(2, 2))
    n = sh.n_hmcs
    epi = sh.epilogue_blocks()
    reduced = {w for _, b in epi if b.tag.startswith("allreduce:reduce") for w in b.writes}
    assert reduced == {f"d_{p}" for p in graph.param_shapes()}
    updated = {w for _, b in epi if b.tag.startswith("allreduce:update") for w in b.writes}
    gathers = [(h, b) for h, b in epi if b.tag.startswith("allgather:")]
    for p, shape in graph.param_shapes().items():
        assert f"{p}_new" in updated and f"v_{p}_new" in updated
        size = int(np.prod(shape))
        mine = [(h, b) for h, b in gathers if b.reads == (f"{p}_new",)]
        assert len(mine) == min(n, size)
        assert sorted(h for h, _ in mine) == list(range(len(mine)))
        assert sum(b.dma_bytes_out for _, b in mine) == pytest.approx(size * 4 * (n - 1))


def test_shard_programs_partition_the_combined_stream():
    graph, _ = _graphs()
    sh = shard_training_step(graph, mesh_shape=(2, 2))
    owned = [h for h in sh.hmc_of_block if h != ALL_HMCS]
    assert set(owned) == set(range(sh.n_hmcs))
    replicated = sum(1 for h in sh.hmc_of_block if h == ALL_HMCS)
    assert sum(len(sh.shard_program(h).blocks) for h in range(sh.n_hmcs)) == (
        len(sh.program.blocks) + replicated * (sh.n_hmcs - 1))
    gathers = [b for _, b in sh.epilogue_blocks() if b.tag.startswith("allgather:")]
    assert gathers
    assert sh.program.busy_cycles == sh.base_program.busy_cycles + sum(
        b.busy_cycles for b in gathers)


def test_2d_pipeline_structure():
    graph, _ = _graphs()
    sh = shard_training_step(graph, mesh_shape=(2, 2), shard="2d")
    meta = sh.program.meta["mesh"]
    pmeta = meta["pipeline"]
    assert pmeta["n_stages"] == 2
    assert [nd for st in pmeta["stages"] for nd in st] == [nd.name for nd in graph.nodes]
    assert meta["row_owners"] == [[0, 1], [2, 3]]
    assert {(x["src"], x["dst"]) for x in pmeta["xfers"]} == {(0, 1), (1, 0)}
    tags = [b.tag for b in sh.program.blocks]
    for x in pmeta["xfers"]:
        sends = [t for t in tags if t.startswith(f"send:{x['region']}[")]
        recvs = [t for t in tags if t.startswith(f"recv:{x['region']}[")]
        assert sends and len(sends) == len(recvs), x
    row_of = {h: r for r, ro in enumerate(meta["row_owners"]) for h in ro}
    for h, b in sh.epilogue_blocks():
        if b.tag.startswith(("allreduce:", "allgather:")):
            name = b.writes[0] if b.writes else b.reads[0]
            base = name.removeprefix("d_").removeprefix("v_").removesuffix("_new")
            assert row_of[h] == pmeta["param_rows"][base], (b.tag, h)
    assert any(t.startswith("tpgather:") for t in tags)


def test_2d_traffic_conservation():
    graph, _ = _graphs()
    sh = shard_training_step(graph, mesh_shape=(2, 2), shard="2d")
    comm = sum(b.busy_cycles for b in sh.program.blocks
               if b.tag.startswith(("tpgather:", "allgather:", "send:", "recv:")))
    assert comm > 0
    assert sh.program.busy_cycles == sh.base_program.busy_cycles + comm


# ---------------------------------------------------------------------------
# Errors: the same messages
# ---------------------------------------------------------------------------


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


@pytest.mark.parametrize("case", ["indivisible", "bad_shard", "too_many_rows", "parse",
                                  "reshard_outside", "reshard_dead_shard", "reshard_row",
                                  "reshard_all", "degenerate"])
def test_errors_match_jax(case):
    graph, jgraph = _graphs()
    g6, j6 = _graphs(batch=6)
    sh, jsh = (shard_training_step(graph, mesh_shape=(2, 2)),
               j_shard(jgraph, mesh_shape=(2, 2)))
    sh2, jsh2 = (shard_training_step(graph, mesh_shape=(2, 2), shard="2d"),
                 j_shard(jgraph, mesh_shape=(2, 2), shard="2d"))
    calls = {
        "indivisible": ((shard_training_step, g6), (j_shard, j6), {"mesh_shape": (2, 2)}),
        "bad_shard": ((shard_training_step, graph), (j_shard, jgraph),
                      {"mesh_shape": (2, 2), "shard": "3d"}),
        "too_many_rows": ((shard_training_step, graph), (j_shard, jgraph),
                          {"mesh_shape": (8, 1), "shard": "2d"}),
        "parse": ((parse_mesh, "2by2"), (j_parse_mesh, "2by2"), {}),
        "reshard_outside": ((reshard_training_step, sh, 9), (j_reshard, jsh, 9), {}),
        "reshard_dead_shard": ((reshard_training_step(sh, 1).shard_program, 1),
                               (j_reshard(jsh, 1).shard_program, 1), {}),
        "reshard_row": ((reshard_training_step, sh2, (0, 1)), (j_reshard, jsh2, (0, 1)), {}),
        "reshard_all": ((reshard_training_step, sh, (0, 1, 2, 3)),
                        (j_reshard, jsh, (0, 1, 2, 3)), {}),
        "degenerate": ((shard_training_step, graph), (j_shard, jgraph), {"mesh_shape": (0, 2)}),
    }
    (fn, *args), (jfn, *jargs), kw = calls[case]
    assert _message(fn, *args, **kw) == _message(jfn, *jargs, **kw)
    assert parse_mesh("2x4") == (2, 4) and parse_mesh((4, 4)) == (4, 4)


# ---------------------------------------------------------------------------
# The link layer: JAX's figures at ==
# ---------------------------------------------------------------------------


def test_link_constants_are_jaxs():
    for name in ("LINK_BW", "HOP_LATENCY", "CUBE_POWER_MESH", "P_LINKS", "HMC_DRAM_BYTES"):
        assert getattr(t_mesh, name) == getattr(j_mesh, name), name


def _schedule_view(sched):
    return [(st.transfer.link, st.transfer.num_bytes, st.transfer.start, st.transfer.tag,
             st.t0, st.t1) for st in sched.transfers], sched.makespan, sched.congestion_time


@pytest.mark.parametrize("rows,cols", [(2, 2), (4, 4), (8, 8), (16, 16), (4, 2), (2, 4),
                                       (1, 4), (4, 1), (1, 1)])
def test_systolic_update_matches_jax_and_eq15(rows, cols):
    net, jnet = MeshInterconnect(rows, cols), j_mesh.MeshInterconnect(rows, cols)
    for w in (1e6, 300e6):
        got = net.systolic_update(w)
        assert _schedule_view(got) == _schedule_view(jnet.systolic_update(w))
        assert net.update_time(w) == jnet.update_time(w)
        assert expected_update_time(w, rows, cols) == j_mesh.expected_update_time(w, rows, cols)
        want = sum(2.0 * (w / LINK_BW + ax * HOP_LATENCY) for ax in (rows, cols) if ax > 1)
        assert net.update_time(w) == pytest.approx(want, rel=1e-12)
        assert got.congestion_time == 0.0


def test_link_congestion_serializes():
    net, jnet = MeshInterconnect(2, 2), j_mesh.MeshInterconnect(2, 2)
    link = ((0, 0), (0, 1))
    for transfers in ([(link, LINK_BW), (link, LINK_BW)],
                      [(link, LINK_BW), (((1, 0), (1, 1)), LINK_BW)]):
        got = net.schedule([LinkTransfer(lk, b) for lk, b in transfers])
        want = jnet.schedule([j_mesh.LinkTransfer(lk, b) for lk, b in transfers])
        assert _schedule_view(got) == _schedule_view(want)
    s = net.schedule([LinkTransfer(link, LINK_BW), LinkTransfer(link, LINK_BW)])
    assert s.transfers[1].queued == pytest.approx(1.0 + HOP_LATENCY)
    assert s.makespan == pytest.approx(2.0 + 2 * HOP_LATENCY)


@pytest.mark.parametrize("rows,cols,failed", [(1, 4, ()), (2, 2, ()), (4, 4, (5,)),
                                              (2, 4, (2,))])
def test_ring_allreduce_matches_jax(rows, cols, failed):
    """The snake ring, its wrap edge routed store-and-forward (1x4), and the
    survivor ring of a degraded mesh around its holes."""
    net = MeshInterconnect(rows, cols, failed=failed)
    jnet = j_mesh.MeshInterconnect(rows, cols, failed=failed)
    got = net.ring_allreduce(4e6)
    assert _schedule_view(got) == _schedule_view(jnet.ring_allreduce(4e6))
    assert net._snake_nodes() == jnet._snake_nodes()
    assert net.update_time(4e6) == jnet.update_time(4e6)
    if (rows, cols) == (1, 4):
        step_t = 4e6 / 4 / LINK_BW + HOP_LATENCY
        assert got.makespan == pytest.approx(2 * 3 * step_t + 2 * step_t)


def test_bogus_links_and_failed_cubes_match_jax():
    net, jnet = MeshInterconnect(2, 2), j_mesh.MeshInterconnect(2, 2)
    for link in (((0, 0), (1, 1)), ((0, 0), (0, 2))):
        assert _message(net.schedule, [LinkTransfer(link, 1.0)]) == _message(
            jnet.schedule, [j_mesh.LinkTransfer(link, 1.0)])
    dead, jdead = MeshInterconnect(2, 2, failed=(1,)), j_mesh.MeshInterconnect(2, 2, failed=(1,))
    assert dead.alive_nodes == jdead.alive_nodes and (0, 1) not in dead.alive_nodes
    assert _message(dead._check_link, ((0, 0), (0, 1))) == _message(
        jdead._check_link, ((0, 0), (0, 1)))
    assert _message(dead.systolic_update, 1e6) == _message(jdead.systolic_update, 1e6)
    part = MeshInterconnect(2, 2, failed=(0, 3))
    assert _message(part.ring_allreduce, 1e6) == _message(
        j_mesh.MeshInterconnect(2, 2, failed=(0, 3)).ring_allreduce, 1e6)
    assert _message(MeshInterconnect, 0, 2) == _message(j_mesh.MeshInterconnect, 0, 2)


# ---------------------------------------------------------------------------
# Timed mesh steps: JAX's figures at ==
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,shard,kills", [
    ((2, 2), "1d", ()), ((1, 1), "1d", ()), ((2, 4), "1d", ()), ((2, 2), "2d", ()),
    ((2, 4), "2d", ()), ((2, 2), "1d", (2,)), ((2, 2), "2d", (1,))])
def test_time_mesh_step_matches_jax(mesh, shard, kills):
    graph, jgraph = _graphs()
    sh = shard_training_step(graph, mesh_shape=mesh, shard=shard)
    jsh = j_shard(jgraph, mesh_shape=mesh, shard=shard)
    for h in kills:
        sh, jsh = reshard_training_step(sh, h), j_reshard(jsh, h)
    got = time_mesh_step(sh, n_clusters=4)
    want = j_mesh.time_mesh_step(jsh, n_clusters=4)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    assert got.t_step == want.t_step and got.parallel_eff == want.parallel_eff
    if shard == "1d" and not kills and mesh != (1, 1):
        assert got.t_update == pytest.approx(expected_update_time(sh.allreduce_bytes, *mesh))
    if kills:
        assert got.n_alive == sh.n_alive
        assert got.parallel_eff == pytest.approx(got.speedup / got.n_alive)


# the full-width step's modeled figures (paper CNN, batch 64, img 32,
# n_clusters 16): blocks, commands, images a cube, and the summary's figures at
# the digits given (NTX cycle model at 1.5 GHz and the link schedule)
FULL_WIDTH = {
    ("1x1", "1d"): ((114, 11_606, 64), {"t_shard_ms": "0.7836687", "t_update_ms": "0",
                                        "parallel_eff": "1.0"}),
    ("2x2", "1d"): ((403, 11_811, 16), {"t_shard_ms": "0.204012", "t_update_ms": "0.1629168",
                                        "speedup": "2.13575", "parallel_eff": "0.533938"}),
    ("2x2", "2d"): ((287, 11_751, 16), {"n_micro": "16", "bubble_frac": "0.208807",
                                        "t_update_ms": "0.0812984",
                                        "parallel_eff": "0.477804",
                                        "link_congestion_ms": "2.305904"}),
}


@pytest.mark.parametrize("mesh,shard", list(FULL_WIDTH), ids=[f"{m}-{s}" for m, s in FULL_WIDTH])
def test_full_width_figures_match_jax(mesh, shard):
    graph, jgraph = _graphs(batch=64, img=32)
    prog = lower_training_step(graph)
    sh = shard_training_step(graph, mesh_shape=mesh, program=prog, shard=shard)
    counts, figures = FULL_WIDTH[(mesh, shard)]
    assert (len(sh.program.blocks), sh.program.n_commands, sh.shard_batch) == counts
    assert sh.allreduce_bytes == 43_752.0
    base = j_mesh.time_mesh_step(j_shard(jgraph, mesh_shape=mesh, shard=shard)).summary()
    got = time_mesh_step(sh).summary()
    assert got == base
    for name, fig in figures.items():
        digits = len(fig.split(".")[1]) if "." in fig else 0
        assert round(float(got[name]), digits) == float(fig), (name, got[name])


# ---------------------------------------------------------------------------
# The sharded route's fusion plan
# ---------------------------------------------------------------------------


def _plan_view(plan):
    segs = [("step", s.step) if s.region is None else
            ("region", s.region.label, s.region.inputs, s.region.outputs, s.region.batch)
            for s in plan.segments]
    return segs, plan.fallback_steps, plan.fused_commands, plan.total_commands


@pytest.mark.parametrize("img,mesh", [(8, (1, 1)), (8, (2, 2)), (16, (1, 1))])
@pytest.mark.parametrize("fuse_updates", [False, True])
def test_sharded_plans_match_jax(img, mesh, fuse_updates):
    """plan_fusion of a sharded program: JAX's plan with its spill barriers,
    and JAX's on a program without them (the card's spilled=())."""
    graph, jgraph = _graphs(img=img)
    prog = lower_training_step(graph, n_clusters=1 if img == 16 else 16)
    jprog = j_lower_training_step(jgraph, n_clusters=1 if img == 16 else 16)
    sh = shard_training_step(graph, mesh_shape=mesh, program=prog)
    jsh = j_shard(jgraph, mesh_shape=mesh, program=jprog)
    spilled = sh.program.meta["spilled"]
    assert bool(spilled) == (img == 16)
    want = j_plan_fusion(jsh.program, fuse_updates=fuse_updates)
    got = plan_fusion(sh.program, spilled=spilled, fuse_updates=fuse_updates)
    assert _plan_view(got) == _plan_view(want)
    bare = dataclasses.replace(jsh.program, meta={**jsh.program.meta, "spilled": ()})
    card = plan_fusion(sh.program, fuse_updates=fuse_updates)
    assert _plan_view(card) == _plan_view(j_plan_fusion(bare, fuse_updates=fuse_updates))
    if not fuse_updates and mesh == (1, 1) and img == 8:
        assert card.n_regions == 4 and len(card.fallback_steps) == 4
        assert all(k.endswith(":upd") for k in card.fallback_steps)


# ---------------------------------------------------------------------------
# Telemetry: link counters and the merged trace's mesh lanes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,shard,kills", [((2, 2), "1d", ()), ((2, 2), "2d", ()),
                                              ((2, 2), "1d", (1,))])
def test_link_counters_match_schedule_and_jax(mesh, shard, kills):
    graph, jgraph = _graphs(batch=4)
    reg, jreg = obs.CounterRegistry(), j_obs.CounterRegistry()
    with obs.use_registry(reg):
        sh = shard_training_step(graph, mesh_shape=mesh, n_clusters=4, shard=shard)
        for h in kills:
            sh = reshard_training_step(sh, h)
        time_mesh_step(sh, n_clusters=4)
    with j_obs.use_registry(jreg):
        jsh = j_shard(jgraph, mesh_shape=mesh, n_clusters=4, shard=shard)
        for h in kills:
            jsh = j_reshard(jsh, h)
        j_mesh.time_mesh_step(jsh, n_clusters=4)
    assert reg.counters() == jreg.counters()
    assert reg.get("shard/programs") == 1 and reg.get("shard/hmcs") == 4
    assert reg.get("shard/allreduce_bytes") == sh.allreduce_bytes
    if shard == "1d" and not kills:
        upd = MeshInterconnect(*mesh).systolic_update(sh.allreduce_bytes)
        assert reg.total("link_hops") == len(upd.transfers)
        assert reg.total("link_bytes") == sum(st.transfer.num_bytes for st in upd.transfers)


def _modeled(events):
    """The trace's modeled events (cluster, link and flow lanes): host spans
    carry wall-clock times and are left out."""
    return [e for e in events if e.get("pid") != "host"]


@pytest.mark.parametrize("kills", [(), (1,)])
def test_mesh_step_lanes_match_jax(kills, tmp_path):
    graph, jgraph = _graphs(batch=4)
    col, jcol = obs.TraceCollector(), j_obs.TraceCollector()
    with obs.use_collector(col):
        sh = shard_training_step(graph, mesh_shape=(2, 2), n_clusters=4)
        for h in kills:
            sh = reshard_training_step(sh, h)
        result, upd = col.add_mesh_step(sh, n_clusters=4)
    with j_obs.use_collector(jcol):
        jsh = j_shard(jgraph, mesh_shape=(2, 2), n_clusters=4)
        for h in kills:
            jsh = j_reshard(jsh, h)
        jresult, jupd = jcol.add_mesh_step(jsh, n_clusters=4)
    assert result.total_cycles == jresult.total_cycles
    assert _schedule_view(upd) == _schedule_view(jupd)
    assert _modeled(col.events) == _modeled(jcol.events)
    cats = {e.get("cat") for e in col.events}
    assert {"exec", "dma", "link", "lowering", "flow"} <= cats
    assert {"hmc0", "mesh", "host"} <= {e["pid"] for e in col.events}
    starts = [e["id"] for e in col.events if e["ph"] == "s"]
    assert sorted(starts) == sorted(e["id"] for e in col.events if e["ph"] == "f")
    col.save(tmp_path / "trace.json")
