"""The port's LM graph route against the JAX package's.

The decoder-only transformer as one NTX training-step program: the LM
lowering rules (attention, layernorm, residual add, embedding, positional
embedding), ``NetworkGraph.from_model_config`` and its lowering with the
fan-out ``:acc`` steps, the token-row fusion rule, ``run_torch``'s LM
routes, the update-only regions, ``lm_token_batches`` and the driver
``run_ntx_lm``. Sizes: ``tests/test_graph.py::_tiny_lm``'s config (d 16, 2
heads of 8, d_ff 32, vocab 13) and the reduced ``qwen1_5_0_5b`` at batch 2,
seq 8; the full-width Qwen1.5-0.5B graph (batch 2, seq 64) is checked by
structure and the NTX cycle model only. Both packages get the same seeded
numpy inputs; tolerances are ``tests/test_graph.py``'s (rtol 1e-4, atol
1e-5) unless a test says otherwise.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.lower as jl
from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.kernels.fused import build_region_callable as jax_region_callable
from repro.launch.train import _dag_oracle_loss as j_dag_oracle_loss
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import fused
from repro_torch.launch.train import _dag_oracle_loss, run_ntx_lm
from repro_torch.lower import (
    NS_DESIGN,
    AttentionSpec,
    EmbeddingSpec,
    LayerNormSpec,
    NetworkGraph,
    PosEmbedSpec,
    ResidualAddSpec,
    lm_token_batches,
    lower,
    lower_training_step,
    one_hot_rows,
    plan_fusion,
    run_reference,
    run_timing,
    run_torch,
    train_graph,
)
from repro_torch.models.config import ModelConfig

ROOT = Path(__file__).resolve().parents[1]
TOL = {"rtol": 1e-4, "atol": 1e-5}
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=16, n_heads=2, n_kv_heads=2,
            head_dim=8, d_ff=32, vocab_size=13)
QWEN_EPS = get_config("qwen1_5_0_5b").norm_eps  # 1e-6, baked into the layernorm specs


def _tiny(batch=2, seq=6, n_layers=2, momentum=0.0):
    kw = dict(TINY, n_layers=n_layers)
    return (NetworkGraph.from_model_config(ModelConfig(**kw), batch=batch, seq=seq, lr=0.05,
                                           momentum=momentum),
            jl.NetworkGraph.from_model_config(JModelConfig(**kw), batch=batch, seq=seq,
                                              lr=0.05, momentum=momentum))


def _reduced(batch=2, seq=8):
    return (NetworkGraph.from_model_config(reduce_config(get_config("qwen1_5_0_5b")),
                                           batch=batch, seq=seq),
            jl.NetworkGraph.from_model_config(j_reduce_config(j_get_config("qwen1_5_0_5b")),
                                              batch=batch, seq=seq))


def _same_program(got, want):
    assert got.name == want.name
    assert [b.tag for b in got.blocks] == [b.tag for b in want.blocks]
    for g, w in zip(got.blocks, want.blocks):
        assert dataclasses.astuple(g) == dataclasses.astuple(w), g.tag
    assert list(got.regions) == list(want.regions)
    for name in want.regions:
        assert dataclasses.astuple(got.regions[name]) == dataclasses.astuple(want.regions[name])
    assert (got.n_commands, got.n_offloads, got.busy_cycles, got.memory_words) == (
        want.n_commands, want.n_offloads, want.busy_cycles, want.memory_words)


def _step_inputs(graph, seed):
    rng = np.random.RandomState(seed)
    V, rows = graph.loss.classes, graph.loss.batch
    return {graph.input_edge: one_hot_rows(rng.randint(0, V, rows), V),
            graph.label_edge: one_hot_rows(rng.randint(0, V, rows), V),
            **graph.init_params(seed=seed + 1)}


# ---------------------------------------------------------------------------
# the LM lowering rules, command for command, then executed
# ---------------------------------------------------------------------------

LM_SPECS = [
    (AttentionSpec(6, 2, 4), "fwd"), (AttentionSpec(6, 2, 4), "dx"),
    (AttentionSpec(8, 2, 8), "dx"),
    (LayerNormSpec(10, 8), "fwd"), (LayerNormSpec(10, 8), "dw"), (LayerNormSpec(10, 8), "dx"),
    (LayerNormSpec(12, 16, QWEN_EPS), "fwd"), (LayerNormSpec(12, 16, QWEN_EPS), "dx"),
    (ResidualAddSpec((5, 7)), "fwd"), (ResidualAddSpec((5, 7)), "dx"),
    (EmbeddingSpec(6, 11, 5), "fwd"), (EmbeddingSpec(6, 11, 5), "dw"),
    (PosEmbedSpec(3, 4, 5), "fwd"), (PosEmbedSpec(3, 4, 5), "dw"), (PosEmbedSpec(3, 4, 5), "dx"),
]


def _jax_spec(spec):
    return getattr(jl, type(spec).__name__)(**dataclasses.asdict(spec))


def _rule_inputs(program, spec, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for r in program.regions.values():
        if r.kind not in ("input", "param"):
            continue
        if isinstance(spec, EmbeddingSpec) and r.name == "x":  # one-hot token rows
            out[r.name] = one_hot_rows(rng.randint(0, spec.vocab, spec.rows), spec.vocab)
        else:
            out[r.name] = rng.randn(*r.shape).astype(np.float32)
    return out


@pytest.mark.parametrize("ns", [False, True], ids=["ntx", "ns"])
@pytest.mark.parametrize("spec,pass_", LM_SPECS,
                         ids=[f"{type(s).__name__}-{p}-{i}" for i, (s, p) in enumerate(LM_SPECS)])
def test_lm_rules_match_jax(spec, pass_, ns):
    got = lower(spec, pass_, **(dict(design=NS_DESIGN) if ns else {}))
    want = jl.lower(_jax_spec(spec), pass_, **(dict(design=jl.NS_DESIGN) if ns else {}))
    _same_program(got, want)
    if ns:
        return
    inputs = _rule_inputs(want, spec, seed=len(want.blocks))
    out = run_reference(got, inputs, device="cpu")
    ref = jl.run_reference(want, inputs)
    assert set(out) == set(ref)
    for k, v in ref.items():
        if isinstance(spec, AttentionSpec):  # vexp: the port's exp is the correctly rounded one
            np.testing.assert_allclose(out[k].numpy(), v, **TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


# ---------------------------------------------------------------------------
# the LM training-step program
# ---------------------------------------------------------------------------

STEP_CASES = [("tiny", 2, 6, 2, False), ("tiny", 2, 6, 1, False), ("tiny", 3, 4, 1, True),
              ("reduced", 2, 8, 0, False)]


@pytest.mark.parametrize("kind,batch,seq,n_layers,ns", STEP_CASES,
                         ids=[f"{k}-b{b}-s{s}-l{n}-{'ns' if ns else 'ntx'}"
                              for k, b, s, n, ns in STEP_CASES])
def test_lm_training_step_program_matches_jax(kind, batch, seq, n_layers, ns):
    graph, jgraph = (_tiny(batch, seq, n_layers) if kind == "tiny" else _reduced(batch, seq))
    got = lower_training_step(graph, **(dict(design=NS_DESIGN) if ns else {}))
    want = jl.lower_training_step(jgraph, **(dict(design=jl.NS_DESIGN) if ns else {}))
    _same_program(got, want)
    acc = {b.tag.split(":")[0] for b in got.blocks if ":acc:" in b.tag}
    assert acc == set(_fan_out(graph)) and len(acc) == 2 * (n_layers or 2)
    for key in ("batch", "n_clusters", "keep_grads", "peak_tcdm_bytes", "tcdm_budget_bytes",
                "spilled", "intervals", "steps"):
        assert got.meta[key] == want.meta[key], key
    assert got.n_staging_offloads == want.n_staging_offloads


def _fan_out(graph):
    from repro_torch.lower import edge_consumers

    return {e: ns for e, ns in edge_consumers(graph).items() if len(ns) > 1}


# ---------------------------------------------------------------------------
# the full-width Qwen1.5-0.5B step, by structure and the NTX cycle model
# ---------------------------------------------------------------------------


def test_full_width_qwen_program_matches_jax():
    """Batch 2, seq 64: the JAX package's counts and block-engine cycles; the
    card's fusion plan (no spill barrier) has the 97 update-only regions."""
    graph = NetworkGraph.from_model_config(get_config("qwen1_5_0_5b"), batch=2, seq=64)
    assert len(graph.nodes) == 244
    assert sum(math.prod(s) for s in graph.param_shapes().values()) == 550_406_144
    prog = lower_training_step(graph)
    assert (len(prog.blocks), prog.n_commands, prog.n_offloads) == (10_257, 14_217, 4_020)
    assert len(prog.meta["spilled"]) == 2_194
    assert prog.meta["peak_tcdm_bytes"] == 1_048_576 == prog.meta["tcdm_budget_bytes"]
    assert prog.memory_words == 2_101_989_796
    cycles = run_timing(prog, n_clusters=16, engine="block").total_cycles
    assert cycles == 42_067_031_703
    jprog = jl.lower_training_step(jl.NetworkGraph.from_model_config(
        j_get_config("qwen1_5_0_5b"), batch=2, seq=64))
    assert (len(jprog.blocks), jprog.n_commands, jprog.memory_words) == (
        len(prog.blocks), prog.n_commands, prog.memory_words)
    assert jprog.meta["spilled"] == prog.meta["spilled"]
    assert jl.run_timing(jprog, n_clusters=16, engine="block").total_cycles == cycles
    card = plan_fusion(prog)
    assert (card.n_regions, len(card.fallback_steps)) == (97, 735)
    assert all(len(s.region.stages) == 1 and s.region.stages[0].pass_ == "upd"
               for s in card.segments if s.region is not None)
    assert max(math.prod(graph.param_shapes()[s.region.stages[0].param])
               for s in card.segments if s.region is not None) == 155_582_464  # the head
    # with JAX's spill barrier every update touches a spilled region: no region
    assert plan_fusion(prog, spilled=prog.meta["spilled"]).stats() == jl.plan_fusion(
        jprog).stats()


# ---------------------------------------------------------------------------
# the token-row fusion rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["tiny", "reduced"])
def test_lm_fusion_plan_matches_jax(kind):
    graph, jgraph = _tiny() if kind == "tiny" else _reduced()
    prog = lower_training_step(graph)
    want = jl.plan_fusion(jl.lower_training_step(jgraph))
    got = plan_fusion(prog, spilled=prog.meta["spilled"])
    assert got.stats() == want.stats()
    assert [(s.region.label if s.region else s.step) for s in got.segments] == [
        (s.region.label if s.region else s.step) for s in want.segments]
    card = plan_fusion(prog)
    assert all(st.pass_ == "upd" for s in card.segments if s.region for st in s.region.stages)
    assert "loss:dx" in card.fallback_steps
    if kind == "reduced":
        assert (card.n_regions, len(card.fallback_steps)) == (9, 75)
        assert card.coverage == 0.0156794425087108 == want.coverage


# ---------------------------------------------------------------------------
# one step on the torch executor; the gradient oracle
# ---------------------------------------------------------------------------


def test_run_torch_lm_matches_jax_executors():
    """Fused and unfused: JAX's run_pallas (interpret) and run_reference."""
    graph, jgraph = _tiny()
    inputs = _step_inputs(jgraph, seed=8)
    jprog = jl.lower_training_step(jgraph)
    want = jl.run_pallas(jprog, inputs, interpret=True)
    ref = jl.run_reference(jprog, inputs)
    prog = lower_training_step(graph)
    for fuse in (True, False):
        fused.COUNTER.reset()
        got = run_torch(prog, inputs, fuse=fuse, device="cpu")
        assert fused.COUNTER.plain_calls == (9 if fuse else 0)
        assert set(got) == set(want) == set(ref)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL,
                                       err_msg=f"{k} fuse={fuse} vs run_pallas")
            np.testing.assert_allclose(got[k].numpy(), ref[k], **TOL,
                                       err_msg=f"{k} fuse={fuse} vs run_reference")


def test_dag_oracle_gradients_match_jax_grad():
    graph, jgraph = _tiny()
    inputs = _step_inputs(jgraph, seed=3)
    x, onehot = inputs["x"], inputs["onehot"]
    params = {k: v for k, v in inputs.items() if k not in ("x", "onehot")}
    want = jax.grad(lambda p: j_dag_oracle_loss(jgraph, p, jnp.asarray(x),
                                                jnp.asarray(onehot)))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    loss = _dag_oracle_loss(graph, tp, torch.as_tensor(x), torch.as_tensor(onehot))
    jloss = j_dag_oracle_loss(jgraph, params, jnp.asarray(x), jnp.asarray(onehot))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    names = list(graph.param_shapes())
    got = torch.autograd.grad(loss, [tp[p] for p in names])
    for p, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[p]), **TOL, err_msg=p)
    # and the executor's explicit gradients against it
    outs = run_torch(lower_training_step(graph), inputs, device="cpu")
    for p, g in zip(names, got):
        np.testing.assert_allclose(outs[f"d_{p}"].numpy(), g.numpy(), **TOL, err_msg=p)


# ---------------------------------------------------------------------------
# the token stream; three steps against JAX's train_graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [13, 128])
def test_lm_token_batches_match_jax(vocab):
    got = lm_token_batches(np.random.RandomState(5), 2, 8, vocab)
    want = jl.lm_token_batches(np.random.RandomState(5), 2, 8, vocab)
    for step in range(3):
        (x, y), (wx, wy) = got(step), want(step)
        assert x.dtype == wx.dtype == np.float32
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)


def test_one_hot_rows_at_the_qwen_vocabulary():
    """rows x V, not V x V: the rows of the identity at V = 151,936."""
    V = 151_936
    ids = np.array([0, 5, V - 1, 5])
    x = one_hot_rows(ids, V)
    assert x.shape == (4, V) and x.dtype == np.float32
    assert np.array_equal(np.argmax(x, axis=1), ids) and x.sum() == 4.0
    (tok, nxt) = lm_token_batches(np.random.RandomState(0), 1, 4, V)(0)
    assert tok.shape == (4, V) and np.array_equal(nxt, (np.argmax(tok, axis=1) * 3 + 1) % V)


def test_three_step_losses_match_jax_train_graph():
    """The reduced config, batch 2, seq 8: the torch executor (fused) and the
    command interpreter against JAX's train_graph on its interpreter."""
    graph, jgraph = _reduced()
    V = graph.loss.classes
    params = jgraph.init_params(seed=0)
    want = jl.train_graph(jgraph, 3, jl.lm_token_batches(np.random.RandomState(0), 2, 8, V),
                          backend="reference", params=params)
    got = train_graph(graph, 3, lm_token_batches(np.random.RandomState(0), 2, 8, V),
                      params=params, device="cpu")
    ref = train_graph(graph, 3, lm_token_batches(np.random.RandomState(0), 2, 8, V),
                      backend="reference", params=params, device="cpu")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(ref["losses"], want["losses"], rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    assert got["fusion"].n_regions == 9
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, **TOL, err_msg=k)


# ---------------------------------------------------------------------------
# update-only regions
# ---------------------------------------------------------------------------


def _upd_region_cases():
    cases = []
    for label, (graph, jgraph) in (("reduced", _reduced()), ("tiny-momentum",
                                                              _tiny(momentum=0.9))):
        jplan = jl.plan_fusion(jl.lower_training_step(jgraph))
        tplan = plan_fusion(lower_training_step(graph))
        pairs = [(j.region, t.region) for j, t in zip(jplan.segments, tplan.segments)
                 if t.region is not None]
        assert pairs and len(pairs) == jplan.n_regions
        for i in (0, len(pairs) - 1):
            cases.append(pytest.param(graph, pairs[i], id=f"{label}-r{i}"))
    return cases


@pytest.mark.parametrize("graph,pair", _upd_region_cases())
def test_update_only_region_matches_jax_region_kernel(graph, pair):
    jregion, region = pair
    assert all(st.pass_ == "upd" for st in region.stages)
    shapes = graph.param_shapes()
    rng = np.random.RandomState(len(region.inputs))
    ins = {n: rng.randn(*shapes[n.split("_", 1)[1] if n.startswith(("d_", "v_")) else n])
           .astype(np.float32) for n, _ in region.inputs}
    want = jax.jit(jax_region_callable(jregion, interpret=True))(
        {k: jnp.asarray(v) for k, v in ins.items()})
    got = fused.region_torch(region, {k: torch.from_numpy(v) for k, v in ins.items()})
    assert set(got) == set(want) == {n for n, _ in region.outputs}
    for k in got:
        # test_torch_fused.py's region band: XLA may contract w - lr * dw into one FMA
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    c = fused.compile_region(region, {n: v.shape for n, v in ins.items()})
    assert c.n_stages == 0 and c.smem == 0 and c.arena == 0
    assert fused.entry(c) == fused.SMEM and c.n_params == len(region.stages)


def test_update_only_region_tables_at_the_head_size():
    """The head's update (155,582,464 elements) compiles to an empty body and
    one epilogue record within the epilogue's 32-bit index; a parameter past
    it is refused."""
    graph = NetworkGraph.from_model_config(get_config("qwen1_5_0_5b"), batch=2, seq=64)
    prog = lower_training_step(graph)
    head = next(s.region for s in plan_fusion(prog).segments
                if s.region is not None and s.region.stages[0].param == "w_head")
    c = fused.compile_region(head, {"w_head": (1024, 151_936), "d_w_head": (1024, 151_936)})
    assert (c.n_stages, c.n_params, c.max_param_numel) == (0, 1, 155_582_464)
    assert c.epilogue[1:] == [-1, 1, -1, 0, -1, 2, -1]  # dw read as an input; w; w_new
    n = fused.MAX_EPI_NUMEL + 1
    with pytest.raises(ValueError, match="32-bit index"):
        fused.compile_region(head, {"w_head": (n,), "d_w_head": (n,)})


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def test_run_ntx_lm_reduced_check_grads(monkeypatch):
    res = run_ntx_lm("qwen1_5_0_5b", 3, 2, 8, reduced=True, device="cpu", check_grads=True)
    assert res["losses"][-1] < res["losses"][0]
    assert res["grad_err"] < 1e-4 and res["timing"].total_cycles > 0
    assert res["fusion"].n_regions == 9
    # a mesh takes the single-device walk on one rank; two ranks wait for A6b
    from repro_torch.lower import executors

    monkeypatch.setattr(executors, "world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        run_ntx_lm("qwen1_5_0_5b", 1, 2, 8, mesh="1x2", device="cpu")


def test_cli_lm_reduced_check_grads():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--backend", "ntx", "--model",
         "qwen1_5_0_5b", "--reduced", "--steps", "3", "--batch", "2", "--seq", "8",
         "--check-grads", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "574 commands" in out and "9 regions + 75 fallback steps" in out
    assert "gradient check vs torch.autograd: 16 params OK" in out
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--model", "qwen1_5_0_5b",
         "--reduced", "--mesh", "1x2", "--chaos", "kill:hmc=1@step=1", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode != 0 and "ROADMAP A6" in proc.stderr
