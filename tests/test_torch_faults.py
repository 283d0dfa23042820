"""Fault injection on the mesh of HMCs: the port's chaos layer vs the JAX package's.

``repro_torch.runtime.faults`` gives ``repro.runtime.faults``'s schedules
(the same grammar, the same errors, the same counter-keyed draws of a seeded
schedule), retry delays and modeled recovery at ``==``; its
``ChaosController`` drives ``train_graph(chaos=)`` through kills, preemptions
and stragglers with the step discarded BEFORE it commits, so a chaos run
gives the healthy run's losses and parameters bit for bit (the reference
backend; the torch backend on the ``2x2`` walk and on the ``1x2`` kill,
which moves the run from the single-device walk to the sharded route).
Each test of ``tests/test_faults.py`` has its counterpart here. The port's
plain interpreter is not JAX's bit for bit across packages (its ``vexp`` is
the correctly rounded exp, ``tests/test_torch_ntx.py``), so a chaos run
meets JAX's runs at rtol 1e-5 / atol 1e-6 and its own healthy run exactly.

Paper CNN at batch 4, img 8, three steps (batch 64, img 32 for the modeled
recovery of the full-width step).
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.lower import paper_cnn_graph as j_paper_cnn_graph
from repro.lower import reshard_training_step as j_reshard
from repro.lower import shard_training_step as j_shard
from repro.runtime import faults as j_faults
from repro.runtime.mesh import MeshInterconnect as JMeshInterconnect
from repro_torch import obs
from repro_torch.kernels import fused
from repro_torch.launch import train
from repro_torch.lower import (
    executors,
    lower_training_step,
    paper_cnn_graph,
    reshard_training_step,
    run_reference,
    shard_training_step,
    train_graph,
)
from repro_torch.runtime import faults
from repro_torch.runtime.faults import (
    ChaosController,
    ChaosSchedule,
    RetryPolicy,
    time_recovery,
)
from repro_torch.runtime.mesh import MeshInterconnect, time_mesh_step

B, IMG, STEPS = 4, 8, 3
REF_STEPS = 2  # the plain interpreter takes about a second a step here
TOL = {"rtol": 1e-5, "atol": 1e-6}


def _inputs(graph, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(graph.batch, IMG, IMG, 3).astype(np.float32)
    labels = rng.randint(0, graph.loss.classes, graph.batch)
    onehot = np.eye(graph.loss.classes, dtype=np.float32)[labels]
    return {"x": x, "onehot": onehot, **graph.init_params(seed=seed + 1)}


def batch_fn(i):
    """Step-keyed batches: batch_fn(i) depends only on i (replayable)."""
    rng = np.random.RandomState(100 + i)
    return rng.randn(B, IMG, IMG, 3).astype(np.float32), rng.randint(0, 10, B)


def _graphs():
    return paper_cnn_graph(batch=B, img=IMG), j_paper_cnn_graph(batch=B, img=IMG)


def _run(spec, mesh=(2, 2), backend="reference", **ctl_kw):
    graph, _ = _graphs()
    sh = shard_training_step(graph, mesh_shape=mesh)
    ctl = ChaosController(spec, sharded=sh, **ctl_kw) if spec is not None else None
    steps = REF_STEPS if backend == "reference" else STEPS
    res = train_graph(graph, steps, batch_fn, backend=backend, program=sh.program,
                      params=graph.init_params(seed=0), device="cpu", chaos=ctl)
    return res, ctl


def _drive_jax(spec, mesh=(2, 2), steps=STEPS, **ctl_kw):
    """JAX's controller through the hook order of ``steps`` steps (its
    report depends on the events alone, not on the numerics)."""
    _, jgraph = _graphs()
    params = jgraph.init_params(seed=0)
    ctl = j_faults.ChaosController(spec, sharded=j_shard(jgraph, mesh_shape=mesh), **ctl_kw)
    ctl.start(None, params)
    i = 0
    while i < steps:
        action = ctl.intercept(i, None, params)
        if action is not None:
            i = action.resume_step
            continue
        ctl.committed(i, params)
        i += 1
    return ctl


@pytest.fixture(scope="module")
def healthy():
    """The reference backend's healthy 2x2 runs, the port's and JAX's."""
    from repro.lower.graph import train_graph as j_train_graph

    graph, jgraph = _graphs()
    want = j_train_graph(jgraph, REF_STEPS, batch_fn, backend="reference",
                         program=j_shard(jgraph, mesh_shape=(2, 2)).program,
                         params=jgraph.init_params(seed=0))
    got, _ = _run(None)
    return got, want


def _same_run(got, want, exact=True):
    if exact:
        np.testing.assert_array_equal(got["losses"], want["losses"])
    else:
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    assert set(got["params"]) == set(want["params"])
    for k in want["params"]:
        if exact:
            np.testing.assert_array_equal(got["params"][k], want["params"][k], err_msg=k)
        else:
            np.testing.assert_allclose(got["params"][k], np.asarray(want["params"][k]), **TOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# ChaosSchedule: grammar + determinism, equal to JAX's
# ---------------------------------------------------------------------------


def _events(s):
    return [(e.step, e.kind, e.hmc, e.slow) for e in s.events]


def test_parse_scripted_grammar():
    spec = "straggle:hmc=0,slow=2.5@step=3;kill:hmc=1@step=2;preempt@step=5"
    s = ChaosSchedule.parse(spec)
    assert [e.step for e in s.events] == [2, 3, 5]
    kill, strag, pre = s.events
    assert (kill.kind, kill.hmc) == ("kill", 1)
    assert (strag.kind, strag.hmc, strag.slow) == ("straggle", 0, 2.5)
    assert (pre.kind, pre.hmc) == ("preempt", None)
    assert bool(s)
    assert _events(s) == _events(j_faults.ChaosSchedule.parse(spec))
    assert [e.describe() for e in s.events] == [
        e.describe() for e in j_faults.ChaosSchedule.parse(spec).events]


@pytest.mark.parametrize("spec", ["none", "", "  NONE  "])
def test_parse_none_is_empty(spec):
    s = ChaosSchedule.parse(spec)
    assert not s and s.events == ()
    assert not j_faults.ChaosSchedule.parse(spec)


@pytest.mark.parametrize("bad", [
    "kill@step=2",               # kill needs hmc=
    "straggle@step=1",           # straggle needs hmc=
    "explode:hmc=1@step=2",      # unknown kind
    "kill:hmc=1",                # missing @step=
    "kill:hmc=1,wat=3@step=2",   # unknown param
    "random:p_kill=0.5",         # seeded spec needs seed=
    "random:seed=1,bogus=2",     # unknown random key
])
def test_parse_rejects_bad_specs(bad):
    with pytest.raises(ValueError) as got:
        ChaosSchedule.parse(bad)
    with pytest.raises(ValueError) as want:
        j_faults.ChaosSchedule.parse(bad)
    assert str(got.value) == str(want.value)


def test_scripted_event_fires_once():
    s = ChaosSchedule.parse("kill:hmc=1@step=2")
    assert [e.describe() for e in s.events_at(2, 4)] == ["kill:hmc1@step2"]
    assert s.events_at(2, 4) == []  # replaying the step: already fired
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultEvent(0, "melt")


def _history(module, spec, n_hmcs, steps=51):
    s = module.ChaosSchedule.parse(spec)
    return [[e.describe() for e in s.events_at(step, n_hmcs)] for step in range(steps)]


@pytest.mark.parametrize("n_hmcs", [4, 16])
@pytest.mark.parametrize("spec", [
    "random:seed=7,p_kill=0.02,p_straggle=0.05,slow=3,max_kills=2",
    "random:seed=8,p_kill=0.02,p_straggle=0.05",
    "random:seed=0,p_kill=0.1,max_kills=3",
    "random:seed=123,p_straggle=0.2,slow=2.5",
])
def test_seeded_events_equal_jaxs(spec, n_hmcs):
    """Steps 0-50: the same events at every step as JAX's schedule."""
    got = _history(faults, spec, n_hmcs)
    assert got == _history(j_faults, spec, n_hmcs)
    assert got == _history(faults, spec, n_hmcs), "the same seed replays the same history"
    flat = [e for step in got for e in step]
    assert flat, spec
    kills = [e for e in flat if e.startswith("kill")]
    assert len(kills) <= ChaosSchedule.parse(spec).max_kills


def test_seeded_schedule_is_deterministic():
    spec = "random:seed=7,p_kill=0.02,p_straggle=0.05,slow=3,max_kills=2"
    a = [e for step in _history(faults, spec, 16, 60) for e in step]
    assert a == [e for step in _history(faults, spec, 16, 60) for e in step] and a
    assert len([e for e in a if e.startswith("kill")]) <= 2
    other = "random:seed=8,p_kill=0.02,p_straggle=0.05"
    assert [e for step in _history(faults, other, 16, 60) for e in step] != a


def test_retry_policy_backoff_bounds():
    p = RetryPolicy(max_retries=6, base_delay=0.5, factor=2.0, max_delay=4.0)
    ds = p.delays()
    assert ds == [0.5, 1.0, 2.0, 4.0, 4.0, 4.0]
    assert ds == j_faults.RetryPolicy(max_retries=6, base_delay=0.5, factor=2.0,
                                      max_delay=4.0).delays()
    assert RetryPolicy().delays() == j_faults.RetryPolicy().delays()
    with pytest.raises(ValueError):
        p.delay(-1)


# ---------------------------------------------------------------------------
# Elastic re-sharding: bit-identical on the survivors (the plain interpreter)
# ---------------------------------------------------------------------------


def test_reshard_reference_bit_identical():
    graph = paper_cnn_graph(batch=B, img=IMG, momentum=0.9)
    prog = lower_training_step(graph)
    sh = shard_training_step(graph, mesh_shape=(2, 2), program=prog)
    degraded = reshard_training_step(sh, 1)
    assert degraded.alive_hmcs == (0, 2, 3) and degraded.failed_hmcs == (1,)
    inputs = _inputs(graph)
    want = run_reference(prog, inputs, device="cpu")
    got = run_reference(degraded.program, inputs, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_reshard_cumulative_kills_bit_identical():
    graph = paper_cnn_graph(batch=B, img=IMG)
    sh = shard_training_step(graph, mesh_shape=(2, 2))
    twice = reshard_training_step(reshard_training_step(sh, 3), 0)
    assert twice.alive_hmcs == (1, 2) and twice.failed_hmcs == (0, 3)
    inputs = _inputs(graph, seed=2)
    want = run_reference(sh.base_program, inputs, device="cpu")
    got = run_reference(twice.program, inputs, device="cpu")
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_reshard_rejects_dead_and_out_of_mesh():
    graph = paper_cnn_graph(batch=8, img=IMG)
    sh = shard_training_step(graph, mesh_shape=(2, 2))
    degraded = reshard_training_step(sh, 1)
    with pytest.raises(ValueError, match="has failed"):
        degraded.shard_program(1)
    with pytest.raises(ValueError, match="outside mesh"):
        reshard_training_step(sh, 9)


@pytest.mark.parametrize("batch,img,mesh,kill,n_clusters", [
    (8, 8, (2, 2), 2, 4), (8, 8, (2, 2), 1, 16), (8, 8, (1, 2), 1, 16),
    (64, 32, (2, 2), 1, 16), (64, 32, (1, 2), 1, 16)])
def test_time_recovery_equals_jaxs(batch, img, mesh, kill, n_clusters):
    """The degraded mesh step and the modeled recovery at ==; the full-width
    figures are the ones chip_smoke.py asserts (930,280 and 1,298,784)."""
    graph = paper_cnn_graph(batch=batch, img=img)
    jgraph = j_paper_cnn_graph(batch=batch, img=img)
    sh = shard_training_step(graph, mesh_shape=mesh)
    jsh = j_shard(jgraph, mesh_shape=mesh)
    degraded, jdeg = reshard_training_step(sh, kill), j_reshard(jsh, kill)
    rec = time_recovery(sh, degraded, n_clusters=n_clusters)
    jrec = j_faults.time_recovery(jsh, jdeg, n_clusters=n_clusters)
    assert rec.summary() == jrec.summary()
    assert rec.cycles() == int(round(rec.t_total * 1.5e9))
    assert rec.overhead_steps == pytest.approx(rec.t_total / rec.healthy_step)
    assert rec.t_detect > 0 and rec.t_restore > 0 and rec.t_replay > 0
    if (batch, mesh, kill, n_clusters) == (8, (2, 2), 2, 4):
        tm = time_mesh_step(degraded, n_clusters=n_clusters)
        assert tm.n_alive == 3 and tm.n_hmcs == 4
        assert tm.parallel_eff == pytest.approx(tm.speedup / 3)
    if batch == 64:
        assert (degraded.alive_hmcs, rec.cycles()) == {
            (2, 2): ((0, 2, 3), 930_280), (1, 2): ((0,), 1_298_784)}[mesh]


# ---------------------------------------------------------------------------
# ChaosController through the train loop (reference backend)
# ---------------------------------------------------------------------------


def test_chaos_kill_run_matches_healthy_exactly(healthy):
    want, jwant = healthy
    got, ctl = _run("kill:hmc=1@step=1")
    assert ctl.sharded.alive_hmcs == (0, 2, 3)
    rep = ctl.report()
    assert rep["remesh_events"] == 1 and rep["recovery_cycles"] > 0
    assert rep == _drive_jax("kill:hmc=1@step=1").report()
    assert [d["step"] for d in got["discarded"]] == [1]
    assert got["program"] is ctl.sharded.program
    _same_run(got, want)
    _same_run(got, jwant, exact=False)


def test_chaos_preempt_rewinds_and_matches_healthy(healthy, tmp_path):
    want, jwant = healthy
    got, ctl = _run("preempt@step=1", ckpt_dir=tmp_path / "ck", ckpt_every=1)
    rep = ctl.report()
    assert rep["preemptions"] == 1
    assert rep == _drive_jax("preempt@step=1", ckpt_dir=tmp_path / "jck").report()
    assert rep["events"] == ["preempt:job@step1", "preempt@step1: restored step 1"]
    _same_run(got, want)
    _same_run(got, jwant, exact=False)


def test_chaos_preempt_rewinds_past_steps(tmp_path):
    """A checkpoint every 2 steps (the torch backend): a preemption at step 1
    rewinds to step 0 and replays step 0 too."""
    want, _ = _run(None, backend="torch")
    got, ctl = _run("preempt@step=1", backend="torch", ckpt_dir=tmp_path / "ck",
                    ckpt_every=2)
    assert ctl.report()["events"] == ["preempt:job@step1", "preempt@step1: restored step 0"]
    assert [d["step"] for d in got["discarded"]] == [1]
    _same_run(got, want)


def test_chaos_gives_up_after_max_retries():
    graph, _ = _graphs()
    ctl = ChaosController("kill:hmc=1@step=1;kill:hmc=2@step=1",
                          sharded=shard_training_step(graph, mesh_shape=(2, 2)),
                          retry=RetryPolicy(max_retries=1))
    with pytest.raises(RuntimeError, match="gave up after 1"):
        train_graph(graph, REF_STEPS, batch_fn, backend="reference",
                    program=ctl.sharded.program,
                    params=graph.init_params(seed=0), device="cpu", chaos=ctl)
    assert ctl.backoffs == [0.5]
    with pytest.raises(RuntimeError, match="gave up after 1"):
        _drive_jax("kill:hmc=1@step=1;kill:hmc=2@step=1", retry=j_faults.RetryPolicy(
            max_retries=1))


def test_chaos_straggler_records_without_changing_numerics(healthy):
    want, _ = healthy
    slept = []
    got, ctl = _run("straggle:hmc=0,slow=4@step=1", sleep_fn=slept.append)
    rep = ctl.report()
    assert rep["straggler_events"] == 1 and ctl.sharded.n_alive == 4
    assert rep == _drive_jax("straggle:hmc=0,slow=4@step=1").report()
    assert slept == [] and got["discarded"] == []
    _same_run(got, want)


def test_backoff_sleeps_through_sleep_fn():
    graph, _ = _graphs()
    slept = []
    ctl = ChaosController("kill:hmc=1@step=0;kill:hmc=3@step=0",
                          sharded=shard_training_step(graph, mesh_shape=(2, 2)),
                          sleep_fn=slept.append)
    assert ctl.intercept(0, None, None).program is ctl.sharded.program
    assert slept == [0.5, 1.0] and ctl.sharded.alive_hmcs == (0, 2)
    assert ctl.intercept(0, None, None) is None  # fired once
    assert ctl.report()["remesh_events"] == 2


def test_kill_without_a_mesh_preempts(tmp_path):
    """No mesh: a kill takes the whole job down and rewinds like a preemption."""
    graph, _ = _graphs()
    ctl = ChaosController("kill:hmc=0@step=1", ckpt_dir=tmp_path / "ck")
    plain = train_graph(graph, STEPS, batch_fn, device="cpu", params=graph.init_params(seed=0))
    got = train_graph(graph, STEPS, batch_fn, device="cpu", params=graph.init_params(seed=0),
                      chaos=ctl)
    rep = ctl.report()
    assert (rep["preemptions"], rep["remesh_events"], rep["alive_hmcs"]) == (1, 0, 1)
    _same_run(got, plain)
    nockpt = ChaosController("preempt@step=1")
    got = train_graph(graph, STEPS, batch_fn, device="cpu", params=graph.init_params(seed=0),
                      chaos=nockpt)
    assert nockpt.report()["events"][-1] == "preempt@step1: no ckpt dir, replaying step"
    _same_run(got, plain)


# ---------------------------------------------------------------------------
# The torch backend: the 2x2 walk and the 1x2 kill across routes
# ---------------------------------------------------------------------------


@pytest.fixture
def route_log(monkeypatch):
    """B1 calls (plain here) and SGD-update dispatches per step, by mesh route."""
    log = []
    orig = executors.run_torch

    def run_torch(graph, inputs, **kw):
        cache = kw["cache"]
        upd0 = sum(p.calls for p in cache._plans.values() if p.key[1] == "upd")
        c0 = fused.COUNTER.plain_calls
        out = orig(graph, inputs, **kw)
        upd = sum(p.calls for p in cache._plans.values() if p.key[1] == "upd") - upd0
        log.append((executors._route_of(graph), fused.COUNTER.plain_calls - c0, upd))
        return out

    monkeypatch.setattr(executors, "run_torch", run_torch)
    return log


def test_torch_1x2_kill_crosses_routes_and_matches(route_log):
    """1x2, kill cube 1 at step 1: steps 0-1 on the single-device walk (one
    region), the discarded step, then the sharded route (four regions that
    end in dW, four plain updates); within rtol 1e-5 / atol 1e-6 of the
    port's healthy run and of JAX's run_pallas (Pallas in interpret mode)."""
    from repro.lower.graph import train_graph as j_train_graph

    want, _ = _run(None, mesh=(1, 2), backend="torch")
    route_log.clear()
    got, ctl = _run("kill:hmc=1@step=1", mesh=(1, 2), backend="torch")
    assert route_log == [("walk", 1, 0), ("walk", 1, 0), ("sharded", 4, 4), ("sharded", 4, 4)]
    assert ctl.sharded.alive_hmcs == (0,)
    assert executors.mesh_route(got["program"]) == "sharded"
    _same_run(got, want, exact=False)
    _, jgraph = _graphs()
    jwant = j_train_graph(jgraph, STEPS, batch_fn, backend="pallas", interpret=True,
                          program=j_shard(jgraph, mesh_shape=(1, 2)).program,
                          params=jgraph.init_params(seed=0))
    _same_run(got, jwant, exact=False)
    assert ctl.report() == _drive_jax("kill:hmc=1@step=1", mesh=(1, 2)).report()


def test_torch_2x2_kill_and_preempt_give_the_healthy_bits(route_log, tmp_path):
    """2x2: three survivors do not divide batch 4, so the walk stays; the
    preemption's restored parameters land on the run's device."""
    want, _ = _run(None, backend="torch")
    route_log.clear()
    got, ctl = _run("kill:hmc=1@step=1", backend="torch")
    assert route_log == [("walk", 1, 0)] * 4 and ctl.sharded.n_alive == 3
    _same_run(got, want)
    got, ctl = _run("preempt@step=2", backend="torch", ckpt_dir=tmp_path / "ck")
    assert ctl.report()["preemptions"] == 1
    _same_run(got, want)


# ---------------------------------------------------------------------------
# Degraded interconnect
# ---------------------------------------------------------------------------


def test_failed_cube_kills_its_links():
    net = MeshInterconnect(2, 2, failed=(1,))
    assert (0, 1) not in net.alive_nodes
    with pytest.raises(ValueError, match="failed cube"):
        net._check_link(((0, 0), (0, 1)))
    with pytest.raises(ValueError, match="degraded"):
        net.systolic_update(1e6)


def test_degraded_update_falls_back_to_survivor_ring():
    healthy = MeshInterconnect(4, 4)
    degraded = MeshInterconnect(4, 4, failed=(5,))
    assert len(degraded.alive_nodes) == 15
    assert healthy.update_time(1e6) == healthy.systolic_update(1e6).makespan
    assert degraded.update_time(1e6) == degraded.ring_allreduce(1e6).makespan
    assert degraded.update_time(1e6) == JMeshInterconnect(4, 4, failed=(5,)).update_time(1e6)
    snake = degraded._snake_nodes()
    assert len(snake) == 15 and (1, 1) not in snake


def test_partitioned_mesh_raises():
    net = MeshInterconnect(2, 2, failed=(0, 3))
    with pytest.raises(ValueError, match="partition"):
        net.ring_allreduce(1e6)


# ---------------------------------------------------------------------------
# Telemetry: chaos/ counters and the recovery lanes, equal to JAX's
# ---------------------------------------------------------------------------


def test_recovery_lanes_equal_jaxs():
    graph, jgraph = _graphs()
    sh, jsh = shard_training_step(graph, mesh_shape=(2, 2)), j_shard(jgraph, mesh_shape=(2, 2))
    deg, jdeg = reshard_training_step(sh, 1), j_reshard(jsh, 1)
    rec = time_recovery(sh, deg, n_clusters=4)
    jrec = j_faults.time_recovery(jsh, jdeg, n_clusters=4)
    col, jcol = obs.TraceCollector(), j_obs.TraceCollector()
    col.add_recovery(2, faults.FaultEvent(2, "kill", 1), rec, deg)
    jcol.add_recovery(2, j_faults.FaultEvent(2, "kill", 1), jrec, jdeg)
    assert col.events == jcol.events
    assert [e["name"] for e in col.events] == ["detect:kill:hmc1@step2", "restore:params",
                                               "replay:step2"]


def test_chaos_counters_equal_jaxs():
    reg, jreg = obs.CounterRegistry(), j_obs.CounterRegistry()
    graph, _ = _graphs()
    ctl = ChaosController("kill:hmc=1@step=1;straggle:hmc=0@step=2",
                          sharded=shard_training_step(graph, mesh_shape=(2, 2)))
    with obs.use_registry(reg):
        ctl.intercept(1, None, None)
        ctl.intercept(2, None, None)
    with j_obs.use_registry(jreg):
        _drive_jax("kill:hmc=1@step=1;straggle:hmc=0@step=2")
    chaos = {k: v for k, v in reg.counters().items() if k.startswith("chaos/")}
    assert chaos == {k: v for k, v in jreg.counters().items() if k.startswith("chaos/")}
    assert set(chaos) == {"chaos/remesh_events", "chaos/recovery_cycles", "chaos/stragglers"}


# ---------------------------------------------------------------------------
# run_ntx_cnn and the CLI
# ---------------------------------------------------------------------------


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    return res, buf.getvalue().splitlines()


def test_run_ntx_cnn_chaos_prints_the_report_and_books_it(tmp_path):
    """run_ntx_cnn(chaos=): the JAX package's chaos lines, the step-keyed data
    (the healthy 'none' run's losses), chaos/ counters in the JSONL and the
    recovery lanes in the trace."""
    metrics, trace = tmp_path / "m.jsonl", tmp_path / "t.json"
    base, _ = _quiet(train.run_ntx_cnn, STEPS, B, IMG, n_clusters=4, mesh="2x2", device="cpu",
                     chaos="none", chaos_ckpt=str(tmp_path / "ck0"))
    res, lines = _quiet(train.run_ntx_cnn, STEPS, B, IMG, n_clusters=4, mesh="2x2",
                        device="cpu", chaos="kill:hmc=1@step=1",
                        chaos_ckpt=str(tmp_path / "ck"), metrics=str(metrics), trace=str(trace))
    jrep = _drive_jax("kill:hmc=1@step=1", n_clusters=4).report()
    assert res["chaos"] == jrep
    assert [ln for ln in lines if ln.startswith("chaos event: ")] == [
        f"chaos event: {e}" for e in jrep["events"]]
    assert (f"chaos report: 1 re-shard(s), 0 preemption(s), 0 straggler(s), "
            f"{jrep['recovery_cycles']} modeled recovery cycles, 3 cube(s) alive at exit"
            in lines)
    assert "chaos: executing via the walk route at exit" in lines
    assert any(ln.startswith("discarded step 1: ") for ln in lines)
    assert res["losses"] == base["losses"] and base["chaos"]["events"] == []
    chaos = {k: v for k, v in res["registry"].counters().items() if "/chaos/" in k}
    assert chaos == {"step1/chaos/remesh_events": 1,
                     "step1/chaos/recovery_cycles": jrep["recovery_cycles"]}
    records = obs.read_jsonl(metrics)
    assert [r["step"] for r in records] == [0, 1, 2]  # committed steps only
    assert [r["counters"].get("recovery_cycles") for r in records] == [
        None, jrep["recovery_cycles"], None]
    assert [r["counters"].get("remesh_events") for r in records] == [None, 1, None]
    events = json.loads(trace.read_text())["traceEvents"]
    rec = [e for e in events if e["pid"] == "recovery"]
    assert [e["name"] for e in rec] == ["detect:kill:hmc1@step1", "restore:params",
                                        "replay:step1"]
    assert {"hmc0", "mesh", "host"} <= {e["pid"] for e in events}


def test_cli_chaos_preempt_on_the_cpu(tmp_path, capsys):
    train._cli(["--device", "cpu", "--steps", "3", "--batch", "4", "--img", "8",
                "--n-clusters", "4", "--chaos", "preempt@step=2",
                "--chaos-ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "chaos event: preempt@step2: restored step 2" in out
    assert ("chaos report: 0 re-shard(s), 1 preemption(s), 0 straggler(s), 0 modeled "
            "recovery cycles, 1 cube(s) alive at exit") in out
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000001", "step_00000002", "step_00000003"]
