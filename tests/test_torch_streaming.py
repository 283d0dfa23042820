"""The port's streaming matmul and im2col conv vs the JAX Pallas kernels.

On CPU tensors the port runs its plain version; the JAX kernel runs in
interpret mode. The CUDA kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import streaming as jax_streaming
from repro_torch.kernels import streaming

# the shape grid of tests/kernels/test_streaming.py (fp32)
SHAPES = [
    (128, 128, 128),
    (128, 128, 512),
    (64, 64, 256),
    (100, 70, 333),  # ragged
    (8, 200, 40),
]


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_streaming_matmul_matches_jax(m, n, k):
    rng = np.random.RandomState(m + n + k)
    a = (rng.randn(m, k) / np.sqrt(k)).astype(np.float32)  # unit-scale outputs
    b = rng.randn(k, n).astype(np.float32)
    want = jax_streaming.streaming_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    got = streaming.streaming_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("view", ["a.T", "b.T", "both"])
@pytest.mark.parametrize("m,n,k", [(100, 70, 333), (75, 16, 256)])
def test_streaming_matmul_transposed_views_match_jax(view, m, n, k):
    """The dW (a.T) and dX (b.T) operand views of the executor."""
    rng = np.random.RandomState(m * n + k)
    a = rng.randn(k, m) if view in ("a.T", "both") else rng.randn(m, k)
    a = (a / np.sqrt(k)).astype(np.float32)  # unit-scale outputs
    b = rng.randn(n, k).astype(np.float32) if view in ("b.T", "both") else \
        rng.randn(k, n).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if view in ("a.T", "both"):
        ta, ja = ta.T, ja.T
    if view in ("b.T", "both"):
        tb, jb = tb.T, jb.T
    assert not (ta.is_contiguous() and tb.is_contiguous())
    want = jax_streaming.streaming_matmul(ja, jb, interpret=True)
    got = streaming.streaming_matmul(ta, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1, 2])
def test_streaming_conv2d_matches_jax(stride, padding):
    rng = np.random.RandomState(3 + stride + padding)
    x = rng.randn(2, 12, 12, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 8).astype(np.float32)
    want = jax_streaming.streaming_conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                          padding=padding, interpret=True)
    got = streaming.streaming_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                     stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    # the tolerances of tests/kernels/test_streaming.py::test_streaming_conv_vs_ref
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("m,n,k,blocks", [
    (256, 128, 512, (128, 128, 128)),
    (100, 70, 333, (None, None, None)),
    (16384, 16, 75, (None, None, None)),
])
def test_streaming_tiles_match_jax(m, n, k, blocks):
    bm, bn, bk = blocks
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    assert streaming.streaming_tiles(m, n, k, **kw) == jax_streaming.streaming_tiles(m, n, k, **kw)


def test_wrapper_counts_plain_calls_on_cpu():
    streaming.COUNTER.reset()
    a, b = torch.ones(4, 3), torch.ones(3, 2)
    out = streaming.streaming_matmul(a, b)
    assert torch.equal(out, torch.full((4, 2), 3.0))
    assert (streaming.COUNTER.launches, streaming.COUNTER.plain_calls) == (0, 1)


def test_kernel_build_failures_raise(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all(("streaming_mm",))
    monkeypatch.setattr(build, "nvcc_path", lambda: "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match="nvcc failed to build streaming_mm.cu"):
        build.build_all(("streaming_mm",))
    assert list(tmp_path.iterdir()) == []  # no partial library is left behind


def test_wrapper_refuses_other_devices_and_shapes():
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        streaming.streaming_matmul(torch.ones(4, 3, device="meta"), torch.ones(3, 2, device="meta"))
    with pytest.raises(ValueError, match="bad shapes"):
        streaming.streaming_matmul(torch.ones(4, 3), torch.ones(2, 2))

