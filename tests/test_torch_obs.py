"""The port's telemetry (``repro_torch.obs``) against the JAX package's.

Counter totals booked by the port's executors equal the program's
closed-form counts (``program_totals``) and the JAX package's digest of the
same program; the registry mechanics, ``block_scope``, ``record_schedule``,
the hotspot table and the metrics JSONL behave as JAX's do; the reference
backend's per-step records equal JAX's in every counter; the torch
backend's records carry the program's counts and its own fusion plan; a
merged trace's ``hmc0`` lanes equal JAX's ``add_cluster_lanes`` events for
the same program, and its host lanes hold one lowering span per emitting
step and one dispatch span per plan call. The CLI writes both files on the
CPU and still needs a card without ``--device cpu``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.lower import lower_training_step as j_lower_training_step
from repro.lower import paper_cnn_graph as j_paper_cnn_graph
from repro.lower import run_timing as j_run_timing
from repro.lower import train_graph as j_train_graph
from repro.obs import counters as j_counters
from repro_torch import obs
from repro_torch.lower import (
    PlanCache,
    lower_training_step,
    paper_cnn_graph,
    run_reference,
    run_timing,
    run_torch,
    train_graph,
)
from repro_torch.obs.counters import _program_digest, block_scope, program_totals
from repro_torch.obs.trace import block_spans

ROOT = Path(__file__).resolve().parents[1]


def _graph_and_inputs(batch=2, img=8, seed=0):
    graph = paper_cnn_graph(batch=batch, img=img, lr=0.05, momentum=0.9)
    prog = lower_training_step(graph, n_clusters=4)
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, img, img, 3).astype(np.float32)
    labels = rng.randint(0, graph.loss.classes, batch)
    inputs = {graph.input_edge: x,
              graph.label_edge: np.eye(graph.loss.classes, dtype=np.float32)[labels],
              **graph.init_params(seed=1)}
    return graph, prog, inputs


def _batches(batch, img, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, img, img, 3).astype(np.float32)
    labels = rng.randint(0, 10, batch)
    return lambda _i: (x, labels)


# ---------------------------------------------------------------------------
# Registry mechanics
# ---------------------------------------------------------------------------


def _fill(mod):
    reg = mod.CounterRegistry()
    with reg.scope("step0"):
        with reg.scope("c1", "fwd"):
            reg.inc("offloads", 3)
            reg.inc("dma_bytes", 100)
            reg.inc("busy_cycles", 5_000_000)
        with reg.scope("c2", "", "fwd"):  # empty parts are dropped
            reg.inc("offloads", 2)
            reg.inc("busy_cycles", 1_234)
    with reg.scope("step1", "c1", "dx"):
        reg.inc("offloads", 7)
        reg.inc("dma_bytes", 2_500_000)
    reg.inc("offloads")  # root scope
    return reg


def test_registry_scoping_prefixes_and_tree_match_jax():
    reg, want = _fill(obs), _fill(j_obs)
    assert reg.counters() == want.counters()
    assert reg.get("step0/c1/fwd/offloads") == 3
    assert reg.total("offloads") == 13 and reg.total("offloads", prefix="step0/") == 5
    assert reg.totals("step1/") == want.totals("step1/") == {"offloads": 7, "dma_bytes": 2_500_000}
    assert reg.totals() == want.totals()
    assert reg.tree() == want.tree()
    assert reg.tree()["step0"]["c1"]["fwd"]["offloads"] == 3
    # "step1/" is not a prefix of "step10/"
    with reg.scope("step10"):
        reg.inc("offloads", 100)
    assert reg.total("offloads", prefix="step1/") == 7


def test_registry_disabled_empty_and_installed():
    off = obs.CounterRegistry(enabled=False)
    off.inc("x", 5)
    obs.record_program(off, _graph_and_inputs()[1])
    assert len(off) == 0 and off.counters() == {}
    empty = obs.CounterRegistry()
    assert bool(empty) and len(empty) == 0  # empty, yet telemetry is on
    assert obs.get_active() is None
    with obs.use_registry(empty) as r:
        assert obs.get_active() is r is empty
        with obs.use_registry(None):
            assert obs.get_active() is None
        assert obs.get_active() is empty
    assert obs.get_active() is None
    assert repr(empty) == repr(j_obs.CounterRegistry())


def test_snapshot_restore_merge_roundtrip():
    reg = _fill(obs)
    snap = reg.snapshot()
    assert json.loads(json.dumps(snap)) == snap
    assert snap == _fill(j_obs).snapshot()
    reg.inc("offloads", 1000)
    reg.restore(snap)
    assert reg.counters() == snap
    other = obs.CounterRegistry()
    other.merge(reg)
    other.merge(snap)
    assert other.get("step0/c1/fwd/offloads") == 6
    reg.clear()
    assert len(reg) == 0
    reg.restore(None)
    assert reg.counters() == {}


@pytest.mark.parametrize("tag", [
    "", "c1:fwd:conv[0]", "fc:dw:matmul", "fc:upd", "loss:dx:xent", "spill:act1",
    "fill:act1", "allreduce:update:fc:upd[0]", "allgather:w_c1[1]", "c1", "c1:zero:pad",
])
def test_block_scope_matches_jax(tag):
    assert block_scope(tag) == j_counters.block_scope(tag)


# ---------------------------------------------------------------------------
# Program counters: closed form, JAX's digest, the executors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,img,n_clusters", [(2, 8, 4), (4, 16, 16), (8, 32, 1)])
def test_record_program_matches_closed_form_and_jax(batch, img, n_clusters):
    prog = lower_training_step(paper_cnn_graph(batch=batch, img=img), n_clusters=n_clusters)
    jprog = j_lower_training_step(j_paper_cnn_graph(batch=batch, img=img),
                                  n_clusters=n_clusters)
    assert _program_digest(prog) == j_counters._program_digest(jprog)
    assert _program_digest(prog) is _program_digest(prog)  # memoised on the program
    assert program_totals(prog) == j_counters.program_totals(jprog)
    reg = obs.CounterRegistry()
    obs.record_program(reg, prog)
    obs.record_program(reg, prog)
    got = reg.totals()
    for leaf, v in program_totals(prog).items():
        assert got[leaf] == 2 * v, leaf
    assert got["macs"] > 0
    if prog.meta["spilled"]:  # batch 8, img 32 on one cluster spills
        assert got["spill_bytes"] > 0 and got["fill_bytes"] > 0


def test_run_timing_records_program_and_schedule():
    _, prog, _ = _graph_and_inputs()
    reg = obs.CounterRegistry()
    with obs.use_registry(reg):
        result = run_timing(prog, n_clusters=4)
    jreg = j_obs.CounterRegistry()
    with j_obs.use_registry(jreg):
        j_run_timing(j_lower_training_step(j_paper_cnn_graph(batch=2, img=8), n_clusters=4),
                     n_clusters=4)
    assert reg.counters() == jreg.counters()
    assert reg.total("commands") == prog.n_commands
    assert reg.get("timing/scheduled_programs") == 1
    assert reg.get("timing/total_cycles") == result.total_cycles
    assert reg.get("timing/exec_cycles") == result.exec_cycles > 0
    with obs.use_registry(None):
        run_timing(prog, n_clusters=4)  # no registry: nothing booked anywhere
    assert reg.get("timing/scheduled_programs") == 1


def test_run_reference_and_run_torch_counters_on_the_cpu():
    graph, prog, inputs = _graph_and_inputs()
    reg = obs.CounterRegistry()
    cache = PlanCache()
    with obs.use_registry(reg):
        with reg.scope("ref"):
            run_reference(prog, inputs, device="cpu")
        with reg.scope("cold"):
            run_torch(prog, inputs, device="cpu", cache=cache)
        with reg.scope("warm"):
            run_torch(prog, inputs, device="cpu", cache=cache)
        with reg.scope("graph"):
            run_torch(graph, inputs, fuse=False, device="cpu", cache=cache)
    want = program_totals(prog)
    for pfx in ("ref/", "cold/", "warm/"):
        for leaf, v in want.items():
            assert reg.total(leaf, prefix=pfx) == v, (pfx, leaf)
    assert not any(k.startswith("ref/") and ("plan_cache" in k or "fusion" in k)
                   for k in reg.counters())
    assert reg.get("cold/plan_cache/misses") == 1 and reg.get("cold/plan_cache/calls") == 1
    assert reg.get("warm/plan_cache/misses") == 0 and reg.get("warm/plan_cache/hits") == 1
    assert "warm/plan_cache/retraces" not in reg.counters()
    fusion = prog.meta["_fusion_plans"][True]
    assert reg.totals("warm/fusion/") == {
        "regions": fusion.n_regions, "fallback_dispatches": len(fusion.fallback_steps),
        "fused_commands": fusion.fused_commands,
        "unfused_commands": fusion.total_commands - fusion.fused_commands}
    # a graph alone books the plan cache, but no program and (unfused) no fusion
    assert reg.total("commands", prefix="graph/") == 0
    assert reg.get("graph/plan_cache/calls") == reg.get("graph/plan_cache/misses") > 1
    assert not any(k.startswith("graph/fusion") for k in reg.counters())


def test_nothing_is_booked_without_a_registry():
    graph, prog, inputs = _graph_and_inputs()
    assert obs.get_active() is None and obs.get_active_trace() is None
    out = run_torch(prog, inputs, device="cpu")
    reg = obs.CounterRegistry()
    with obs.use_registry(reg):
        again = run_torch(prog, inputs, device="cpu")
    for k in out:  # instrumentation changes no bit of the step
        assert torch.equal(out[k], again[k]), k


# ---------------------------------------------------------------------------
# train_graph: per-step scopes and the metrics JSONL
# ---------------------------------------------------------------------------


def test_reference_backend_records_match_jax(tmp_path):
    batch_fn = _batches(2, 8)
    jgraph = j_paper_cnn_graph(batch=2, img=8)
    j_path, path = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jreg = j_obs.CounterRegistry()
    want = j_train_graph(jgraph, 2, batch_fn, backend="reference", registry=jreg,
                         metrics_path=str(j_path))
    reg = obs.CounterRegistry()
    got = train_graph(paper_cnn_graph(batch=2, img=8), 2, batch_fn, backend="reference",
                      device="cpu", params=jgraph.init_params(), registry=reg,
                      metrics_path=str(path))
    assert got["registry"] is reg and obs.get_active() is None
    assert reg.counters() == jreg.counters()
    recs, jrecs = obs.read_jsonl(path), j_obs.read_jsonl(j_path)
    assert [r["step"] for r in recs] == [r["step"] for r in jrecs] == [0, 1]
    for r, jr in zip(recs, jrecs):
        assert set(r) == set(jr) == {"schema_version", "step", "loss", "wall_s", "counters"}
        assert r["schema_version"] == jr["schema_version"] == obs.SCHEMA_VERSION
        assert r["counters"] == jr["counters"]
        assert abs(r["loss"] - jr["loss"]) <= 1e-5
        assert r["wall_s"] > 0
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert recs[0]["counters"]["commands"] == got["program"].n_commands


def test_torch_backend_records_program_and_fusion_counters(tmp_path):
    path = tmp_path / "m.jsonl"
    graph = paper_cnn_graph(batch=2, img=8)
    res = train_graph(graph, 3, _batches(2, 8), device="cpu", registry=obs.CounterRegistry(),
                      metrics_path=str(path))
    prog, fusion = res["program"], res["fusion"]
    assert prog is not None and fusion is prog.meta["_fusion_plans"][True]
    recs = obs.read_jsonl(path)
    assert len(recs) == 3
    for i, r in enumerate(recs):
        c = r["counters"]
        assert r["step"] == i
        for leaf, v in program_totals(prog).items():
            assert c[leaf] == v, (i, leaf)
        assert (c["regions"], c["fallback_dispatches"], c["fused_commands"],
                c["unfused_commands"]) == (fusion.n_regions, len(fusion.fallback_steps),
                                           fusion.fused_commands,
                                           fusion.total_commands - fusion.fused_commands)
        assert (c["misses"], c["hits"], c["calls"]) == ((1, 0, 1) if i == 0 else (0, 1, 1))
        assert r["loss"] == res["losses"][i]
    # the same losses as a run without telemetry, bit for bit
    plain = train_graph(graph, 3, _batches(2, 8), device="cpu")
    assert plain["losses"] == res["losses"]


# ---------------------------------------------------------------------------
# The merged trace
# ---------------------------------------------------------------------------


def _jax_lanes(batch, img, n_clusters, engine):
    col = j_obs.TraceCollector()
    with j_obs.use_collector(col):
        prog = j_lower_training_step(j_paper_cnn_graph(batch=batch, img=img),
                                     n_clusters=n_clusters)
    res = j_run_timing(prog, n_clusters=n_clusters, engine=engine)
    evs = col.add_cluster_lanes(prog, res, n_clusters, pid="hmc0")
    col.link_flows(evs, [])
    return col


@pytest.mark.parametrize("engine", ["event", "block"])
def test_trace_lanes_match_jax(engine, tmp_path):
    n_clusters = 4
    _, _, inputs = _graph_and_inputs()
    col = obs.TraceCollector()
    with obs.use_collector(col):
        prog = lower_training_step(paper_cnn_graph(batch=2, img=8), n_clusters=n_clusters)
        cache = PlanCache()
        run_torch(prog, inputs, device="cpu", cache=cache)
        run_torch(prog, inputs, fuse=False, device="cpu", cache=cache)
    res = run_timing(prog, n_clusters=n_clusters, engine=engine)
    evs = col.add_cluster_lanes(prog, res, n_clusters, pid="hmc0")
    n_flows = col.link_flows(evs, [])
    want = _jax_lanes(2, 8, n_clusters, engine)

    def lanes(c):
        return [e for e in c.events if e["pid"] == "hmc0" and e["ph"] == "X"]

    assert lanes(col) == lanes(want)
    assert sum(e["args"]["commands"] for e in evs) == prog.n_commands
    assert sum(n for *_x, n in block_spans(prog, res, n_clusters)) == prog.n_commands
    # host lanes: one lowering span per emitting step, JAX's names in JAX's order
    lowering = [e["name"] for e in col.events if e.get("cat") == "lowering"]
    assert lowering == [e["name"] for e in want.events if e.get("cat") == "lowering"]
    assert len(set(lowering)) == len(lowering)
    steps = set(prog.meta["steps"])
    emitted = {":".join(b.tag.split(":")[:2]) for b in prog.blocks} & steps
    assert emitted <= {n[len("lower:"):] for n in lowering} <= steps
    # one dispatch span per plan call: one region (fused), then per-node plans
    spans = [e for e in col.events if e.get("cat") in ("fused", "dispatch")]
    assert len(spans) == cache.calls
    assert [e["name"] for e in spans if e["cat"] == "fused"] == [
        prog.meta["_fusion_plans"][True].segments[0].region.label]
    assert all(e["tid"] == "dispatch" and e["pid"] == "host" for e in spans)
    # flows: lowering span -> exec span, one per step key, as in JAX
    assert n_flows == sum(1 for e in want.events if e["ph"] == "s")
    starts = [e["id"] for e in col.events if e["ph"] == "s"]
    assert sorted(starts) == sorted(e["id"] for e in col.events if e["ph"] == "f")
    path = tmp_path / "trace.json"
    assert col.save(path) == str(path)
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ns" and len(doc["traceEvents"]) == len(col.events)


# ---------------------------------------------------------------------------
# Reports and the CLI
# ---------------------------------------------------------------------------


def test_format_hotspots_matches_jax():
    reg, jreg = _fill(obs), _fill(j_obs)
    for k in (1, 3, 5):
        assert obs.format_hotspots(reg, k=k) == j_obs.format_hotspots(jreg, k=k)
        assert obs.hotspots(reg, "offloads", k) == j_obs.hotspots(jreg, "offloads", k)
    txt = obs.format_hotspots(reg, k=3)
    assert "by cycles" in txt and "step0/c1/fwd" in txt and "5.00M" in txt
    assert "by link bytes" not in txt
    assert obs.hotspots(reg, "offloads", prefix="step1/") == [("step1/c1/dx", 7)]


def test_metrics_writer_coerces_tensors_and_arrays(tmp_path):
    path = tmp_path / "sub" / "m.jsonl"
    with obs.MetricsWriter(path) as w:
        w.write({"step": 0, "loss": torch.tensor(1.25), "n": np.int64(3),
                 "metrics": {"ce": torch.tensor([0.5]), "acc": np.float32(0.75),
                             "mat": torch.zeros(2, 2), "ok": True}})
    with obs.MetricsWriter(path, append=True) as w:
        w.write({"step": 1, "loss": None})
    recs = obs.read_jsonl(path)
    assert recs[0] == {"schema_version": 1, "step": 0, "loss": 1.25, "n": 3.0,
                       "metrics": {"ce": 0.5, "acc": 0.75, "mat": str(torch.zeros(2, 2)),
                                   "ok": True}}
    assert recs[1] == {"schema_version": 1, "step": 1, "loss": None}


def test_cli_writes_metrics_and_trace_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "3",
         "--batch", "4", "--img", "8", "--metrics", "m.jsonl", "--trace", "t.json"],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    recs = obs.read_jsonl(tmp_path / "m.jsonl")
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(r["counters"]["commands"] > 0 for r in recs)
    doc = json.loads((tmp_path / "t.json").read_text())
    cats = {e.get("cat") for e in doc["traceEvents"]}
    assert {"exec", "dma", "lowering", "fused", "flow"} <= cats
    assert "top-5 hotspots" in proc.stdout and "by cycles:" in proc.stdout


def test_run_ntx_cnn_still_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch.train import run_ntx_cnn

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ntx_cnn(1, 2, 8, metrics=str(tmp_path / "m.jsonl"), trace=str(tmp_path / "t.json"))
    assert not (tmp_path / "m.jsonl").exists()
