"""The port's whole training step and loop vs the JAX package.

Same parameters (``params_from_jax`` of the JAX ``init_params``), same
seeded inputs. ``run_torch`` fused and unfused is held against JAX
``run_pallas`` fused and unfused (Pallas in interpret mode off-TPU) at the
fused-vs-unfused band of tests/test_fuse.py, and against the NTX reference
interpreter ``run_reference`` at its band. Conv dW contracts over the whole
batch in one product here instead of summing per-image dWs, which changes
the summation order: that is inside the 1e-5 / 1e-6 band.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.lower import PlanCache as JaxPlanCache
from repro.lower import lower_training_step, run_pallas, run_reference
from repro.lower import frequency_band_batches as jax_batches
from repro.lower import paper_cnn_graph as jax_paper_cnn_graph
from repro.lower import train_graph as jax_train_graph
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.lower import (
    PlanCache,
    frequency_band_batches,
    paper_cnn_graph,
    run_torch,
    softmax_xent_loss,
    train_graph,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_step():
    """One JAX step at batch 4 / img 16: fused, unfused and reference outputs."""
    graph = jax_paper_cnn_graph(batch=4, img=16, lr=0.05, momentum=0.9)
    program = lower_training_step(graph)
    params = graph.init_params(seed=2)
    rng = np.random.RandomState(3)
    x = rng.randn(4, 16, 16, 3).astype(np.float32)
    onehot = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4)]
    inputs = {"x": x, "onehot": onehot, **params}
    cache = JaxPlanCache()
    outs = {
        "fused": run_pallas(program, inputs, cache=cache, fuse=True),
        "unfused": run_pallas(program, inputs, cache=cache, fuse=False),
    }
    outs = {k: {n: np.asarray(v) for n, v in o.items()} for k, o in outs.items()}
    outs["reference"] = run_reference(program, inputs)
    return params, x, onehot, outs


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_step_matches_jax_run_pallas_and_reference(jax_step, fuse):
    params, x, onehot, want = jax_step
    graph = paper_cnn_graph(batch=4, img=16, lr=0.05, momentum=0.9)
    inputs = {"x": x, "onehot": onehot, **params_from_jax(params, graph, "cpu")}
    got = run_torch(graph, inputs, fuse=fuse, device="cpu", cache=PlanCache())
    assert set(got) == set(want["fused"])
    for jax_route in ("fused", "unfused"):
        for k, v in want[jax_route].items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} vs jax {jax_route}")
    for k, v in want["reference"].items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=2e-3, atol=1e-5,
                                   err_msg=f"{k} vs run_reference")


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_three_step_losses_match_jax_train_graph(fuse):
    jgraph = jax_paper_cnn_graph(batch=4, img=16)
    want = jax_train_graph(jgraph, 3, jax_batches(np.random.RandomState(0), 4, 16),
                           cache=JaxPlanCache(), fuse=fuse)
    graph = paper_cnn_graph(batch=4, img=16)
    got = train_graph(graph, 3, frequency_band_batches(np.random.RandomState(0), 4, 16),
                      params=jgraph.init_params(), fuse=fuse, device="cpu")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=0)
    assert got["losses"][-1] < got["losses"][0]
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_init_params_bit_identical_to_jax():
    for batch, img in [(4, 16), (64, 32)]:
        want = jax_paper_cnn_graph(batch=batch, img=img).init_params(seed=5)
        got = paper_cnn_graph(batch=batch, img=img).init_params(seed=5)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_batches_and_loss_match_jax():
    jx, jy = jax_batches(np.random.RandomState(4), 8, 32)(0)
    tx, ty = frequency_band_batches(np.random.RandomState(4), 8, 32)(0)
    assert np.array_equal(jx, tx) and np.array_equal(jy, ty)
    from repro.lower.graph import softmax_xent_loss as jax_loss

    z = np.random.RandomState(0).randn(8, 10).astype(np.float32)
    assert softmax_xent_loss(z, ty) == jax_loss(z, jy)


def test_params_from_jax_checks_names_and_shapes():
    graph = paper_cnn_graph(batch=4, img=16)
    params = graph.init_params(seed=0)
    tp = params_from_jax(params, graph, "cpu")
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in tp.values())
    back = params_to_numpy(tp)
    assert all(np.array_equal(back[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in params.items() if k != "v_w_fc"}, graph, "cpu")
    bad = dict(params, w_c1=params["w_c1"].T)
    with pytest.raises(ValueError, match="w_c1"):
        params_from_jax(bad, graph, "cpu")


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    graph = paper_cnn_graph(batch=4, img=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_torch(graph, {}, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_graph(graph, 1, frequency_band_batches(np.random.RandomState(0), 4, 16))


def test_cli_trains_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--backend", "ntx",
         "--device", "cpu", "--steps", "3", "--batch", "4", "--img", "16"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = [float(line.split("loss=")[1].split()[0])
              for line in proc.stdout.splitlines() if line.startswith("step ")]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert "fusion: 1 regions + 0 fallback steps" in proc.stdout
    assert "ntx train-step program: 82 blocks, 774 commands" in proc.stdout
    assert "covering 756 of 774 program commands (97.67 %)" in proc.stdout
    assert "plan cache:" in proc.stdout
