"""The mesh of HMCs on one process: the port's executor route and driver.

``run_reference`` of a sharded program (the combined command stream, on the
plain interpreter for CPU tensors) is bit-identical to the unsharded step.
``run_torch`` takes JAX's ``_run_pallas_graph_mesh`` rule with ranks of a
``torch.distributed`` process group for devices (``executors.mesh_route``,
the rank count stubbed here, never a process group): the single-device
walk (updates fused) with fewer ranks than live HMCs or an uneven batch,
the sharded walk (``fuse_updates=False``, the gradient reduce between dW and
the update) for one HMC on one rank, and a refusal naming ROADMAP A6b for
two or more ranks. Both routes match the port's ``run_reference`` at JAX's
rtol 2e-3 / atol 1e-5, and the sharded walk matches JAX's ``run_pallas``
(Pallas in interpret mode). The driver prints the JAX driver's mesh lines
and losses; ``--chaos`` on the LM route is refused, as the JAX CLI refuses
it (the CNN's chaos runs: ``tests/test_torch_faults.py``).

Paper CNN at batch 4-8, img 8, on the CPU.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from repro.lower import paper_cnn_graph as j_paper_cnn_graph
from repro.lower import run_reference as j_run_reference
from repro.lower import shard_training_step as j_shard
from repro_torch.kernels import fused
from repro_torch.launch import train
from repro_torch.lower import (
    PlanCache,
    executors,
    lower_training_step,
    paper_cnn_graph,
    reshard_training_step,
    run_reference,
    run_torch,
    shard_training_step,
)

BAND = {"rtol": 2e-3, "atol": 1e-5}  # tests/test_mesh.py: run_pallas vs run_reference


def _inputs(graph, seed=0):
    """tests/test_mesh.py's inputs: randn images, random labels, the graph's
    own initial parameters."""
    rng = np.random.RandomState(seed)
    b, img = graph.batch, graph.input_shape[0]
    x = rng.randn(b, img, img, 3).astype(np.float32)
    labels = rng.randint(0, graph.loss.classes, b)
    onehot = np.eye(graph.loss.classes, dtype=np.float32)[labels]
    return {"x": x, "onehot": onehot, **graph.init_params(seed=seed + 1)}


def _close(got, want, band=BAND):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(torch.as_tensor(np.array(got[k])),
                                   torch.as_tensor(np.array(want[k])), **band, msg=k)


@pytest.fixture
def ranks(monkeypatch):
    """Stub the rank count the mesh route reads (no process group)."""
    def set_ranks(n):
        monkeypatch.setattr(executors, "world_size", lambda: n)
    return set_ranks


# ---------------------------------------------------------------------------
# run_reference: the combined stream is the unsharded step, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard,kills", [("1d", ()), ("2d", ()), ("1d", (1,))])
def test_reference_of_sharded_stream_is_bit_identical(shard, kills):
    graph = paper_cnn_graph(batch=4, img=8, momentum=0.9)
    prog = lower_training_step(graph)
    sh = shard_training_step(graph, mesh_shape=(2, 2), program=prog, shard=shard)
    for h in kills:
        sh = reshard_training_step(sh, h)
    inputs = _inputs(graph)
    want = run_reference(prog, inputs, device="cpu")
    got = run_reference(sh.program, inputs, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_reference_of_sharded_stream_matches_jax():
    """The port's interpreter on the sharded stream against JAX's on JAX's
    sharded stream: the step band of tests/test_torch_lower.py (vexp)."""
    graph = paper_cnn_graph(batch=4, img=8)
    inputs = _inputs(graph, seed=3)
    got = run_reference(shard_training_step(graph, mesh_shape=(2, 2)).program, inputs,
                        device="cpu")
    want = j_run_reference(j_shard(j_paper_cnn_graph(batch=4, img=8),
                                   mesh_shape=(2, 2)).program, inputs)
    _close(got, want, {"rtol": 1e-5, "atol": 1e-6})


# ---------------------------------------------------------------------------
# The mesh route of run_torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,shard,kills,n_ranks,route", [
    ((1, 1), "1d", (), 1, "sharded"),
    ((2, 2), "1d", (), 1, "walk"),
    ((2, 2), "2d", (), 1, "walk"),
    ((2, 2), "1d", (1,), 1, "walk"),      # three survivors: 8 % 3
    ((2, 2), "1d", (1, 2), 1, "walk"),    # two survivors, one rank
    ((2, 2), "1d", (), 2, "walk"),        # fewer ranks than HMCs
    ((2, 2), "1d", (1,), 4, "walk"),      # ranks enough, the batch does not divide
    ((2, 2), "1d", (), 4, "A6b"),
    ((1, 1), "1d", (), 2, "A6b"),
    ((2, 2), "1d", (1, 2), 2, "A6b"),
])
def test_mesh_route_rule(ranks, mesh, shard, kills, n_ranks, route):
    graph = paper_cnn_graph(batch=8, img=8)
    sh = shard_training_step(graph, mesh_shape=mesh, shard=shard)
    for h in kills:
        sh = reshard_training_step(sh, h)
    ranks(n_ranks)
    if route == "A6b":
        with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
            executors.mesh_route(sh.program)
        with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
            run_torch(sh.program, _inputs(graph), device="cpu")
        return
    assert executors.mesh_route(sh.program) == route
    fusion = executors.step_fusion(sh.program)
    assert any(seg.region is not None and any(st.pass_ == "upd" for st in seg.region.stages)
               for seg in fusion.segments) == (route == "walk")


def test_world_size_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert executors.world_size() == 1


@pytest.mark.parametrize("mesh,shard,kills,fuse", [
    ((1, 1), "1d", (), True), ((1, 1), "1d", (), False), ((2, 2), "1d", (), True),
    ((2, 2), "2d", (), True), ((2, 2), "1d", (), False), ((2, 2), "1d", (1,), True),
    ((2, 2), "1d", (1, 2), True)])
def test_run_torch_routes_match_reference(mesh, shard, kills, fuse):
    graph = paper_cnn_graph(batch=4, img=8, momentum=0.9)
    prog = lower_training_step(graph)
    sh = shard_training_step(graph, mesh_shape=mesh, program=prog, shard=shard)
    for h in kills:
        sh = reshard_training_step(sh, h)
    inputs = _inputs(graph, seed=5)
    want = run_reference(prog, inputs, device="cpu")
    fused.COUNTER.reset()
    got = run_torch(sh.program, inputs, fuse=fuse, device="cpu")
    _close(got, want)
    regions = 0 if not fuse else 4 if mesh == (1, 1) else 1
    assert fused.COUNTER.plain_calls == regions
    # the same numerics as the unsharded step's walk
    unsharded = run_torch(graph, inputs, fuse=fuse, device="cpu")
    for k in unsharded:
        torch.testing.assert_close(got[k], unsharded[k], rtol=1e-5, atol=1e-6, msg=k)


def test_sharded_route_matches_jax_run_pallas():
    """The 1x1 route (one rank) against JAX's run_pallas on its 1x1 program
    (shard_map over one device, Pallas in interpret mode)."""
    from repro.lower import PlanCache as JPlanCache
    from repro.lower import run_pallas

    graph = paper_cnn_graph(batch=4, img=8, momentum=0.9)
    jgraph = j_paper_cnn_graph(batch=4, img=8, momentum=0.9)
    inputs = _inputs(graph, seed=5)
    got = run_torch(shard_training_step(graph, mesh_shape=(1, 1)).program, inputs,
                    device="cpu")
    want = run_pallas(j_shard(jgraph, mesh_shape=(1, 1)).program, inputs, cache=JPlanCache())
    _close(got, {k: np.asarray(v) for k, v in want.items()}, {"rtol": 1e-5, "atol": 1e-6})


def test_grad_reduce_hook_on_the_sharded_route():
    """The sharded route's plan leaves every update a per-node step after
    the gradient reduce: a hook doubling it doubles the kept gradients and
    moves every update; a region that holds an update refuses a hook."""
    graph = paper_cnn_graph(batch=4, img=8, momentum=0.9)
    inputs = _inputs(graph, seed=2)
    cpu, cache = torch.device("cpu"), PlanCache()
    j = executors._as_f32(inputs, cpu)
    sh1 = shard_training_step(graph, mesh_shape=(1, 1))
    seen = []

    def doubled(g):
        seen.append(tuple(g.shape))
        return 2 * g

    def walk(program, hook):
        return executors._walk(graph, j, lambda s, p: cache.get(s, p, cpu),
                               executors.step_fusion(program).segments, keep_grads=True,
                               grad_reduce=hook)

    base = run_torch(sh1.program, inputs, device="cpu")
    for k, v in walk(sh1.program, executors._identity).items():
        assert torch.equal(v, base[k]), k
    got = walk(sh1.program, doubled)
    assert sorted(seen) == sorted(tuple(s) for s in graph.param_shapes().values())
    for p in graph.param_shapes():
        torch.testing.assert_close(got[f"d_{p}"], 2 * base[f"d_{p}"])
        v_new = graph.momentum * j[f"v_{p}"] + got[f"d_{p}"]
        torch.testing.assert_close(got[f"v_{p}_new"], v_new)
        assert not torch.equal(got[f"{p}_new"], base[f"{p}_new"])
    with pytest.raises(ValueError, match="fuse_updates=False"):
        walk(shard_training_step(graph, mesh_shape=(2, 2)).program, doubled)


def test_shard_slice_walk_is_a_missing_allreduce():
    """The walk of one shard's images (batch= the slice, the loss keeping
    the global 1/B) gives that shard's share of every gradient: the shares
    of the four shards sum to the whole batch's gradient."""
    graph = paper_cnn_graph(batch=8, img=8, momentum=0.9)
    inputs = _inputs(graph, seed=4)
    whole = run_torch(graph, inputs, device="cpu")
    plan = executors.step_fusion(shard_training_step(graph, mesh_shape=(2, 2)).program)
    cpu, cache = torch.device("cpu"), PlanCache()
    shares = []
    for i in range(4):
        part = {k: (v[2 * i:2 * i + 2] if k in ("x", "onehot") else v) for k, v in inputs.items()}
        shares.append(executors._walk(graph, executors._as_f32(part, cpu),
                                      lambda s, p: cache.get(s, p, cpu), plan.segments,
                                      keep_grads=True, batch=2))
    for p in graph.param_shapes():
        total = sum(s[f"d_{p}"] for s in shares)
        torch.testing.assert_close(total, whole[f"d_{p}"], rtol=1e-5, atol=1e-6, msg=p)
        assert not torch.allclose(shares[0][f"{p}_new"], whole[f"{p}_new"], rtol=1e-5,
                                  atol=1e-6)
    lg = graph.logits_edge
    torch.testing.assert_close(torch.cat([s[lg] for s in shares]), whole[lg])


def test_program_memos_are_kept_per_fuse_updates():
    graph = paper_cnn_graph(batch=4, img=8)
    sh = shard_training_step(graph, mesh_shape=(1, 1))
    a = executors._fusion_for(sh.program, fuse_updates=False)
    b = executors._fusion_for(sh.program, fuse_updates=True)
    assert a is executors._fusion_for(sh.program, fuse_updates=False) and a is not b
    assert (a.n_regions, len(a.fallback_steps), b.n_regions, len(b.fallback_steps)) == (
        4, 4, 1, 0)
    assert executors.step_fusion(sh.program) is a


# ---------------------------------------------------------------------------
# The driver: the JAX driver's mesh lines and losses
# ---------------------------------------------------------------------------


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    return res, buf.getvalue().splitlines()


def _mesh_lines(lines):
    """The lines the JAX driver prints for a mesh, the mesh line up to the
    route it names (its executors differ: shard_map vs ranks)."""
    out = []
    for ln in lines:
        if ln.startswith("mesh "):
            out.append(ln.split("; executing via")[0])
        elif ln.startswith(("2d pipeline:", "modeled mesh step:", "2d timing:")):
            out.append(ln)
    return out


@pytest.fixture(scope="module")
def jax_cnn_runs():
    from repro.launch.train import run_ntx_cnn as j_run_ntx_cnn

    return {shard: _quiet(j_run_ntx_cnn, 2, 4, 8, n_clusters=4, mesh="2x2", shard=shard)
            for shard in ("1d", "2d")}


@pytest.mark.parametrize("mesh,shard,route", [("2x2", "1d", "walk"), ("2x2", "2d", "walk"),
                                              ("1x1", "1d", "sharded")])
def test_run_ntx_cnn_mesh_matches_jax_driver(jax_cnn_runs, mesh, shard, route):
    res, lines = _quiet(train.run_ntx_cnn, 2, 4, 8, n_clusters=4, mesh=mesh, shard=shard,
                        device="cpu")
    assert res["route"] == route
    jres, jlines = jax_cnn_runs[shard]
    if mesh == "2x2":
        assert _mesh_lines(lines) == _mesh_lines(jlines)
    else:
        assert any(ln.startswith("mesh 1x1: 1 HMCs x 4 images") and "sharded walk" in ln
                   for ln in lines)
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-6)
    walk = "single-device walk (1 rank(s) < 4 HMCs)"
    assert any(walk in ln for ln in lines) == (route == "walk")
    assert res["mesh_timing"].summary()["n_hmcs"] == res["sharded"].n_hmcs


def test_run_ntx_lm_mesh_matches_jax_driver():
    from repro.launch.train import run_ntx_lm as j_run_ntx_lm

    res, lines = _quiet(train.run_ntx_lm, "qwen1_5_0_5b", 1, 4, 8, n_clusters=4, mesh="2x2",
                        device="cpu")
    jres, jlines = _quiet(j_run_ntx_lm, "qwen1_5_0_5b", 1, 4, 8, n_clusters=4, mesh="2x2")
    assert res["route"] == "walk"
    assert _mesh_lines(lines) == _mesh_lines(jlines)
    assert any(ln.startswith("mesh 2x2: 4 HMCs x 1 sequences, 2395 blocks") for ln in lines)
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-5)


def test_driver_trace_has_the_mesh_lanes(tmp_path):
    import json

    path = tmp_path / "trace.json"
    _quiet(train.run_ntx_cnn, 1, 4, 8, n_clusters=4, mesh="2x2", device="cpu",
           trace=str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert {"hmc0", "mesh", "host"} <= {e["pid"] for e in events}
    assert any(e.get("cat") == "link" for e in events)


def test_driver_refuses_two_ranks_naming_a6b(ranks):
    ranks(4)
    with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
        _quiet(train.run_ntx_cnn, 1, 4, 8, n_clusters=4, mesh="2x2", device="cpu")


@pytest.mark.parametrize("argv,message", [
    (["--chaos", "kill:hmc=1@step=2", "--mesh", "2x2", "--batch", "4", "--model",
      "qwen1_5_0_5b", "--reduced"], "ROADMAP A6c"),
    (["--mesh", "2by2"], "bad --mesh '2by2'"),
    (["--mesh", "0x2"], "is degenerate"),
    (["--mesh", "2x2", "--batch", "6"], "--batch 6 does not divide over the 2x2 mesh"),
    (["--shard", "2d"], "--shard 2d needs a mesh"),
])
def test_cli_refusals(argv, message):
    with pytest.raises(SystemExit, match=message):
        train._cli(["--device", "cpu", "--steps", "1", "--img", "8", *argv])


def test_validate_mesh_args_matches_jax(capsys):
    from repro.launch.train import validate_mesh_args as j_validate

    for args in (("2by2", "1d", 8), ("0x2", "1d", 8), ("2x2", "1d", 6), (None, "2d", 8),
                 ("2x2", "3d", 8)):
        with pytest.raises(SystemExit) as got:
            train.validate_mesh_args(*args)
        with pytest.raises(SystemExit) as want:
            j_validate(*args)
        assert str(got.value) == str(want.value), args
    assert train.validate_mesh_args("2x2", "2d", 8) == (2, 2)
    assert "1 rank(s) < 4 cubes" in capsys.readouterr().out
    assert train.validate_mesh_args(None, "1d", 8) is None


def test_cli_trains_the_mesh_on_the_cpu(capsys):
    train._cli(["--device", "cpu", "--steps", "3", "--batch", "4", "--img", "8",
                "--n-clusters", "4", "--mesh", "2x2", "--shard", "2d"])
    out = capsys.readouterr().out
    assert "2d pipeline: 2 stage(s)" in out and "modeled mesh step:" in out
