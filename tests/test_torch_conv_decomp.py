"""The port's strided-conv backward decomposition vs the JAX package (§3.2).

Cases span the ranges of tests/test_conv_decomp.py (input 5..14, kernel
1..5, stride 1..3, padding 0..3) as a fixed grid. The decomposition runs
once with its default per-phase correlation and once with the streaming
conv injected, as the torch executor does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conv_decomp as jax_cd
from repro_torch.core import conv_decomp as cd
from repro_torch.kernels import streaming

CASES = [  # (xh, xw, k, stride, padding)
    (5, 5, 1, 1, 0),
    (6, 9, 3, 1, 1),
    (7, 7, 5, 1, 3),
    (8, 8, 3, 2, 1),
    (9, 6, 2, 2, 0),
    (10, 10, 4, 2, 2),
    (11, 7, 5, 2, 2),
    (12, 12, 3, 3, 0),
    (13, 11, 5, 3, 1),
    (14, 14, 4, 3, 3),
    (14, 9, 1, 3, 0),
    (16, 16, 3, 2, 1),  # the paper CNN's conv2 at img 32
]


def _streaming_corr(dy, w_ab, pads):
    ph, pw = pads
    return streaming.streaming_conv2d(streaming.pad_hw(dy, ph, pw), w_ab, stride=1, padding=0)


def _case(xh, xw, k, s, pad):
    rng = np.random.RandomState(xh * 1000 + xw * 100 + k * 10 + s + pad)
    x = rng.randn(2, xh, xw, 3).astype(np.float32)
    w = rng.randn(k, k, 3, 4).astype(np.float32)
    return x, w


@pytest.mark.parametrize("conv_fn", ["default", "streaming"])
@pytest.mark.parametrize("xh,xw,k,s,pad", CASES)
def test_input_grad_decomposition_matches_jax(xh, xw, k, s, pad, conv_fn):
    x, w = _case(xh, xw, k, s, pad)
    dy = np.asarray(jax_cd.conv2d(jnp.asarray(x), jnp.asarray(w), s, pad))
    want = jax_cd.conv2d_input_grad_decomposed(jnp.asarray(dy), jnp.asarray(w), s, (xh, xw), pad)
    kw = {"conv_fn": _streaming_corr} if conv_fn == "streaming" else {}
    got = cd.conv2d_input_grad_decomposed(
        torch.from_numpy(dy), torch.from_numpy(w), s, (xh, xw), pad, **kw
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("xh,xw,k,s,pad", CASES[::2])
def test_conv2d_and_weight_grad_match_jax(xh, xw, k, s, pad):
    x, w = _case(xh, xw, k, s, pad)
    want_y = jax_cd.conv2d(jnp.asarray(x), jnp.asarray(w), s, pad)
    got_y = cd.conv2d(torch.from_numpy(x), torch.from_numpy(w), s, pad)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    dy = np.asarray(want_y)
    want = jax_cd.conv2d_weight_grad(jnp.asarray(x), jnp.asarray(dy), s, (k, k), pad)
    got = cd.conv2d_weight_grad(torch.from_numpy(x), torch.from_numpy(dy), s, (k, k), pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
