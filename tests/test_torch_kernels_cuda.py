"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one; they import nothing of
JAX so that they run on a machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_jax
from repro_torch.kernels import fused, streaming
from repro_torch.lower import (
    MaxPool2dSpec,
    RegionSpec,
    Stage,
    frequency_band_batches,
    paper_cnn_graph,
    plan_fusion,
    run_torch,
)

SHAPES = [(128, 128, 128), (128, 128, 512), (64, 64, 256), (100, 70, 333), (8, 200, 40),
          (16384, 16, 75), (75, 16, 16384)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ops import strict_fp32

    strict_fp32()
    return torch.device("cuda", 0)


def _step_inputs(batch, img, device):
    graph = paper_cnn_graph(batch=batch, img=img)
    x, labels = frequency_band_batches(np.random.RandomState(batch), batch, img)(0)
    inputs = {
        "x": torch.as_tensor(x, device=device),
        "onehot": torch.as_tensor(np.eye(10, dtype=np.float32)[labels], device=device),
        **params_from_jax(graph.init_params(seed=1), graph, device),
    }
    return graph, inputs


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_streaming_kernel_matches_plain(cuda_device, m, n, k):
    g = torch.Generator(device="cpu").manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g).to(cuda_device)
    b = torch.randn(k, n, generator=g).to(cuda_device)
    streaming.COUNTER.reset()
    got = streaming.streaming_matmul(a, b)
    got_t = streaming.streaming_matmul(a.T.contiguous().T, b.T.contiguous().T)
    want = streaming.streaming_matmul_torch(a, b)
    torch.cuda.synchronize()
    assert streaming.COUNTER.launches == 2
    # fp32 sums in another order: the error is held against |A|.|B|
    scale = torch.matmul(a.abs(), b.abs())
    assert float(((got - want).abs() / scale).max()) <= 1e-5
    assert torch.equal(got, got_t)  # strided views take the same arithmetic


@pytest.mark.cuda
@pytest.mark.parametrize("batch,img", [(4, 16), (16, 32)])
def test_region_kernel_matches_plain(cuda_device, batch, img):
    graph, inputs = _step_inputs(batch, img, cuda_device)
    (seg,) = plan_fusion(graph).segments
    ins = {n: inputs[n] for n, _ in seg.region.inputs}
    fused.COUNTER.reset()
    got = fused.build_region_callable(seg.region, device=cuda_device)(ins)
    want = fused.region_torch(seg.region, ins)
    torch.cuda.synchronize()
    assert fused.COUNTER.launches == 1
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-6, msg=k)


@pytest.mark.cuda
def test_region_kernel_maxpool_ties_exact(cuda_device):
    spec = MaxPool2dSpec(8, 8, 32)
    st = Stage(node="p1", pass_="dx", spec=spec, in_edge="x", out_edge="a_p1")
    region = RegionSpec(stages=(st,), batch=8, lr=0.05, momentum=0.0,
                        inputs=(("x", True), ("d_a_p1", True)),
                        outputs=(("d_x", "batched"),))
    g = torch.Generator(device="cpu").manual_seed(0)
    ins = {"x": torch.randint(0, 3, (8, 8, 8, 32), generator=g).float().to(cuda_device),
           "d_a_p1": torch.randn(8, 4, 4, 32, generator=g).to(cuda_device)}
    got = fused.build_region_callable(region, device=cuda_device)(ins)["d_x"]
    want = fused.region_torch(region, ins)["d_x"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_step_fused_matches_unfused(cuda_device):
    graph, inputs = _step_inputs(16, 32, cuda_device)
    fused_out = run_torch(graph, inputs, fuse=True, device=cuda_device)
    unfused = run_torch(graph, inputs, fuse=False, device=cuda_device)
    assert set(fused_out) == set(unfused)
    for k in fused_out:
        torch.testing.assert_close(fused_out[k], unfused[k], rtol=1e-5, atol=1e-6, msg=k)
