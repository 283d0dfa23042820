"""The port's lowering rules, step compiler, reference executor and coverage vs JAX's.

Every CNN lowering rule and ``lower_training_step`` of ``repro_torch.lower``
give the JAX package's programs command block by command block and region
by region (``dataclasses.astuple``; the port's dataclasses mirror JAX's
field by field), at the NTX and the NS design points. ``run_reference``
executes them on the plain interpreter (CPU tensors) and is held against
JAX's ``run_reference`` on the same numpy inputs: bit-identical, except
``vexp`` (the softmax-CE gradient) and what follows it, which stay within
rtol 1e-5 / atol 1e-6. The fusion plan of a program, with JAX's spill
barriers, counts JAX's coverage.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.lower import AttentionSpec as JAttentionSpec
from repro.lower import NS_DESIGN as J_NS
from repro.lower import lower as jlower
from repro.lower import lower_training_step as j_lower_training_step
from repro.lower import paper_cnn_graph as j_paper_cnn_graph
from repro.lower import plan_fusion as j_plan_fusion
from repro.lower import run_reference as j_run_reference
from repro.lower import supported_matrix as j_supported_matrix
from repro.lower import train_graph as j_train_graph
from repro.lower import rules as jrules
from repro_torch.kernels import ntx_exec
from repro_torch.lower import (
    NS_DESIGN,
    BiasSpec,
    Conv2dSpec,
    FlattenSpec,
    GraphNode,
    MatmulSpec,
    MaxPool2dSpec,
    ReluSpec,
    SgdUpdateSpec,
    SoftmaxXentSpec,
    lower,
    lower_layer,
    lower_training_step,
    paper_cnn_graph,
    plan_fusion,
    run_reference,
    run_torch,
    supported_matrix,
    train_graph,
)

SPECS = [  # (port spec, pass): every CNN rule, the strides and paddings the paper uses
    (MatmulSpec(6, 5, 7), "fwd"), (MatmulSpec(6, 5, 7), "dw"), (MatmulSpec(6, 5, 7), "dx"),
    (Conv2dSpec(8, 9, 3, 3, 2, 4), "fwd"),
    (Conv2dSpec(8, 9, 3, 3, 3, 4, padding=1), "fwd"),
    (Conv2dSpec(8, 8, 3, 3, 3, 4, stride=2, padding=1), "dw"),
    (Conv2dSpec(9, 8, 2, 3, 3, 3, stride=2), "dx"),
    (Conv2dSpec(8, 8, 3, 3, 3, 4, stride=2, padding=1), "dx"),
    (Conv2dSpec(11, 10, 2, 5, 4, 3, stride=3, padding=2), "dx"),
    (MaxPool2dSpec(8, 8, 3), "fwd"), (MaxPool2dSpec(9, 9, 2), "dx"),
    (ReluSpec((4, 5)), "fwd"), (ReluSpec((4, 5)), "dx"),
    (BiasSpec(6, 4), "fwd"), (BiasSpec(6, 4), "dw"), (BiasSpec(6, 4), "dx"),
    (SoftmaxXentSpec(4, 10), "dx"),
    (SgdUpdateSpec(12, 0.05), "upd"), (SgdUpdateSpec(12, 0.05, momentum=0.9), "upd"),
]
SPEC_IDS = [f"{type(s).__name__}-{p}-{i}" for i, (s, p) in enumerate(SPECS)]


def _jax_spec(spec):
    return getattr(jrules, type(spec).__name__)(**dataclasses.asdict(spec))


def _same_program(got, want):
    assert got.name == want.name
    assert len(got.blocks) == len(want.blocks)
    for g, w in zip(got.blocks, want.blocks):
        assert dataclasses.astuple(g) == dataclasses.astuple(w), (g.tag, w.tag)
    assert list(got.regions) == list(want.regions)
    for name in want.regions:
        assert dataclasses.astuple(got.regions[name]) == dataclasses.astuple(want.regions[name])
    assert (got.n_commands, got.n_offloads, got.busy_cycles, got.memory_words) == (
        want.n_commands, want.n_offloads, want.busy_cycles, want.memory_words)


def _inputs(program, seed):
    rng = np.random.RandomState(seed)
    return {r.name: rng.randn(*r.shape).astype(np.float32)
            for r in program.regions.values() if r.kind in ("input", "param")}


@pytest.mark.parametrize("ns", [False, True], ids=["ntx", "ns"])
@pytest.mark.parametrize("spec,pass_", SPECS, ids=SPEC_IDS)
def test_layer_programs_match_jax(spec, pass_, ns):
    """Command by command and region by region, then executed: the port's
    outputs are the JAX interpreter's bits (vexp: within the step band)."""
    design = dict(design=NS_DESIGN) if ns else {}
    jdesign = dict(design=J_NS) if ns else {}
    got = lower(spec, pass_, **design)
    want = jlower(_jax_spec(spec), pass_, **jdesign)
    _same_program(got, want)
    if ns:
        return
    inputs = _inputs(want, seed=len(want.blocks))
    if isinstance(spec, SoftmaxXentSpec):
        inputs["onehot"] = np.eye(spec.classes, dtype=np.float32)[np.arange(spec.batch) % 10]
    out = run_reference(got, inputs, device="cpu")
    ref = j_run_reference(want, inputs)
    assert set(out) == set(ref)
    for k, v in ref.items():
        if isinstance(spec, SoftmaxXentSpec):
            np.testing.assert_allclose(out[k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def test_supported_matrix_matches_jax_on_the_ported_specs():
    got = supported_matrix()
    want = j_supported_matrix()
    assert got == {k: want[k] for k in got}
    assert set(got) == {"BiasSpec", "Conv2dSpec", "FlattenSpec", "MatmulSpec", "MaxPool2dSpec",
                        "ReluSpec", "SgdUpdateSpec", "SoftmaxXentSpec"}
    assert set(lower_layer(Conv2dSpec(8, 8, 3, 3, 3, 4))) == {"fwd", "dw", "dx"}


def test_lower_errors_are_precise():
    with pytest.raises(NotImplementedError, match="window == stride"):
        lower(MaxPool2dSpec(9, 9, 2, window=3, stride=2), "dx")
    with pytest.raises(NotImplementedError, match="zero-copy view"):
        lower(FlattenSpec((4, 4, 2)))
    with pytest.raises(NotImplementedError, match="driver core"):
        lower(SoftmaxXentSpec(4, 10), "fwd")
    with pytest.raises(ValueError, match="no parameters"):
        lower(ReluSpec((4,)), "dw")
    with pytest.raises(ValueError, match="no parameters"):
        lower(MaxPool2dSpec(8, 8, 2), "dw")
    with pytest.raises(TypeError, match="ROADMAP A5"):
        lower(JAttentionSpec(seq=8, n_heads=2, head_dim=4), "fwd")
    # NS has no write-back AGU: one command per output element
    ns = lower(MatmulSpec(6, 5, 9), "fwd", design=NS_DESIGN)
    assert ns.n_offloads == 6 * 5 and ns.blocks[0].template.loops == (9, 1, 1, 1, 1)
    assert lower(Conv2dSpec(14, 14, 512, 1, 1, 192)).n_offloads == jlower(
        jrules.Conv2dSpec(14, 14, 512, 1, 1, 192)).n_offloads


STEP_CASES = [(2, 8, False), (4, 16, False), (8, 32, False), (64, 32, False), (2, 8, True),
              (4, 16, True)]


@pytest.mark.parametrize("batch,img,ns", STEP_CASES,
                         ids=[f"b{b}-img{i}-{'ns' if ns else 'ntx'}" for b, i, ns in STEP_CASES])
def test_training_step_program_matches_jax(batch, img, ns):
    got = lower_training_step(paper_cnn_graph(batch=batch, img=img),
                              **(dict(design=NS_DESIGN) if ns else {}))
    want = j_lower_training_step(j_paper_cnn_graph(batch=batch, img=img),
                                 **(dict(design=J_NS) if ns else {}))
    _same_program(got, want)
    for key in ("pass", "batch", "n_clusters", "keep_grads", "peak_tcdm_bytes",
                "tcdm_budget_bytes", "spilled", "intervals", "steps"):
        assert got.meta[key] == want.meta[key], key
    assert got.n_staging_offloads == want.n_staging_offloads


def test_main_path_program_structure():
    """Batch 64 / img 32, the main path's configuration: the JAX program's
    counts, structure only (no execution on the CPU), and the command
    kernel's modes: no command of the step needs the sequential mode."""
    prog = lower_training_step(paper_cnn_graph(batch=64, img=32))
    assert len(prog.blocks) == 114
    assert prog.n_commands == 11_606 and prog.n_staging_offloads == 759
    assert prog.meta["peak_tcdm_bytes"] == 1_033_168 <= prog.meta["tcdm_budget_bytes"] == 2**20
    assert len(prog.meta["spilled"]) == 21
    assert sum(math.prod(b.template.loops) * b.n_commands for b in prog.blocks) == 106_731_647
    modes = ntx_exec.program_table(prog)
    assert modes["per_mode"] == {"sequential": 0, "region": 10_320, "streaming": 1_286}
    assert ntx_exec.program_table(prog) is modes  # cached on the program
    assert modes["table"].shape == (11_606, ntx_exec.ROW_WORDS)


def _step_inputs(graph, seed):
    rng = np.random.RandomState(seed)
    b, img = graph.batch, graph.input_shape[0]
    return {"x": rng.randn(b, img, img, 3).astype(np.float32),
            "onehot": np.eye(10, dtype=np.float32)[rng.randint(0, 10, b)],
            **graph.init_params(seed=seed + 1)}


@pytest.mark.parametrize("batch,img,momentum", [(2, 8, 0.0), (4, 16, 0.9)])
def test_reference_step_matches_jax(batch, img, momentum):
    """One whole step: logits bit-identical (the forward runs no vexp), the
    rest within rtol 1e-5 / atol 1e-6."""
    jgraph = j_paper_cnn_graph(batch=batch, img=img, momentum=momentum)
    inputs = _step_inputs(jgraph, seed=batch)
    want = j_run_reference(j_lower_training_step(jgraph), inputs)
    graph = paper_cnn_graph(batch=batch, img=img, momentum=momentum)
    got = run_reference(lower_training_step(graph), inputs, device="cpu")
    assert set(got) == set(want)
    assert ("v_w_c1_new" in got) == bool(momentum)
    np.testing.assert_array_equal(got[graph.logits_edge].numpy(), want[graph.logits_edge])
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_reference_step_against_the_torch_executor():
    """run_reference vs run_torch (fused and unfused) on one program and its
    graph, at the reference-vs-kernel band of tests/test_torch_train.py."""
    graph = paper_cnn_graph(batch=4, img=16)
    prog = lower_training_step(graph)
    inputs = _step_inputs(graph, seed=3)
    ref = run_reference(prog, inputs, device="cpu")
    for fuse in (True, False):
        got = run_torch(prog, inputs, fuse=fuse, device="cpu")
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-3, atol=1e-5,
                                       err_msg=f"{k} fuse={fuse}")


def test_train_graph_reference_backend_matches_jax():
    """Three steps on the command interpreter: JAX's reference-backend losses."""
    y = np.random.RandomState(3).randint(0, 10, 4)
    base = np.linspace(0, 3.14 * 4, 8)
    imgs = np.stack([np.sin(base[None, :] * (1 + c)) * np.cos(base[:, None] * (1 + c))
                     for c in y])[..., None].repeat(3, axis=-1).astype(np.float32)
    jgraph = j_paper_cnn_graph(batch=4, img=8, lr=0.1, momentum=0.9)
    want = j_train_graph(jgraph, 3, lambda _i: (imgs, y), backend="reference")
    graph = paper_cnn_graph(batch=4, img=8, lr=0.1, momentum=0.9)
    got = train_graph(graph, 3, lambda _i: (imgs, y), backend="reference", device="cpu",
                      params=jgraph.init_params())
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=0)
    assert got["losses"][-1] < got["losses"][0]
    assert got["program"] is not None and got["fusion"] is None
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="backend"):
        train_graph(graph, 1, lambda _i: (imgs, y), backend="pallas", device="cpu")


@pytest.mark.parametrize("batch,img,coverage,regions", [
    (4, 16, 0.9767, 1), (8, 32, 0.2558, 3), (64, 32, 0.0018, 1)])
def test_coverage_with_jax_spill_barriers_matches_jax(batch, img, coverage, regions):
    """plan_fusion of a program with spilled=meta["spilled"] is JAX's plan:
    the same regions and the same command coverage. Without the barriers
    (the card's plan) the whole step is one region."""
    prog = lower_training_step(paper_cnn_graph(batch=batch, img=img))
    got = plan_fusion(prog, spilled=prog.meta["spilled"])
    want = j_plan_fusion(j_lower_training_step(j_paper_cnn_graph(batch=batch, img=img)))
    assert got.stats() == want.stats()
    assert (got.n_regions, round(got.coverage, 4)) == (regions, coverage)
    assert [(s.region.label if s.region else s.step) for s in got.segments] == [
        (s.region.label if s.region else s.step) for s in want.segments]
    card = plan_fusion(prog)  # spill / fill and update-constant blocks stay outside
    assert card.n_regions == 1 and not card.fallback_steps
    assert card.total_commands == prog.n_commands and card.coverage >= max(coverage, 0.97)


def test_fan_out_graphs_are_not_lowered_yet():
    graph = paper_cnn_graph(batch=2, img=8)
    r1 = next(n for n in graph.nodes if n.name == "r1")
    graph.nodes[graph.nodes.index(r1)] = GraphNode(**{**dataclasses.asdict(r1),
                                                      "aux_edges": ("a_c1",)})
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        lower_training_step(graph)


def test_run_reference_checks_its_inputs():
    prog = lower(MatmulSpec(3, 4, 5))
    with pytest.raises(ValueError, match="missing"):
        run_reference(prog, {"a": np.zeros((3, 5), np.float32)}, device="cpu")
    with pytest.raises(ValueError, match="expects shape"):
        run_reference(prog, {"a": np.zeros((5, 3), np.float32),
                             "b": np.zeros((5, 4), np.float32)}, device="cpu")
    out = run_reference(prog, {"a": torch.ones(3, 5), "b": torch.ones(5, 4)}, device="cpu")
    assert torch.equal(out["c"], torch.full((3, 4), 5.0))
