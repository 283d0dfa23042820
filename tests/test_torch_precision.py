"""The port's wide-accumulation numerics (``repro_torch.core.precision``).

On seeded arrays in the normal fp32 range every function equals JAX's
``repro.core.precision`` bit for bit. Subnormals are checked against the
exact fp64 identity instead: XLA on the CPU flushes them to zero, PyTorch
keeps them. Inputs come from numpy seeds; nothing is drawn at random.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jp
from repro_torch.core import precision as tp


def _wide(n, seed, spread=3.0, shape=()):
    rng = np.random.RandomState(seed)
    size = (n, *shape)
    return (rng.randn(*size) * 10.0 ** rng.uniform(-spread, spread, size)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum", "two_prod"])
def test_pairwise_functions_match_jax_bit_for_bit(name):
    a, b = _wide(4096, 0), _wide(4096, 1)
    if name == "fast_two_sum":  # valid for |a| >= |b|
        a, b = np.where(np.abs(a) >= np.abs(b), a, b), np.where(np.abs(a) >= np.abs(b), b, a)
    want = getattr(jp, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tp, name)(_t(a), _t(b))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("axis", [0, -1])
def test_wide_sum_matches_jax_bit_for_bit(axis):
    x = _wide(512, 2, shape=(16,))
    x = x if axis == 0 else x.T
    np.testing.assert_array_equal(tp.wide_sum(_t(x), axis=axis).numpy(),
                                  np.asarray(jp.wide_sum(jnp.asarray(x), axis=axis)))


def test_wide_dot_and_kahan_step_match_jax_bit_for_bit():
    a, b = _wide(512, 3, shape=(16,)).T, np.random.RandomState(4).randn(16, 512).astype(np.float32)
    np.testing.assert_array_equal(tp.wide_dot(_t(a), _t(b)).numpy(),
                                  np.asarray(jp.wide_dot(jnp.asarray(a), jnp.asarray(b))))
    s, c, x = _wide(64, 5), _wide(64, 6, spread=1.0) * 1e-7, _wide(64, 7)
    want = jp.kahan_step(jnp.asarray(s), jnp.asarray(c), jnp.asarray(x))
    for w, g in zip(want, tp.kahan_step(_t(s), _t(c), _t(x))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# a = 0 with a subnormal b: the draws that fail JAX's own test on the CPU,
# where XLA flushes b to zero; and subnormals against normal values
SUBNORMAL = [(0.0, 1.4e-45), (0.0, 3.0e-40), (0.0, 2.54e-41), (-2.54e-41, 1.4e-45),
             (1.0, 3.0e-40), (1e-38, -2.54e-41), (1.17549435e-38, -1.4e-45)]


@pytest.mark.parametrize("a,b", SUBNORMAL)
def test_two_sum_is_error_free_on_subnormals(a, b):
    a32, b32 = np.float32(a), np.float32(b)
    s, e = tp.two_sum(torch.tensor(a32), torch.tensor(b32))
    assert np.float64(s.item()) + np.float64(e.item()) == np.float64(a32) + np.float64(b32)
    if a32 == 0:
        assert s.item() == b32 and e.item() == 0.0  # kept, not flushed


def test_two_sum_and_two_prod_are_error_free_in_fp64():
    a, b = _wide(20_000, 8, spread=6.0), _wide(20_000, 9, spread=6.0)
    s, e = tp.two_sum(_t(a), _t(b))
    np.testing.assert_array_equal(s.numpy().astype(np.float64) + e.numpy(),
                                  a.astype(np.float64) + b)
    a, b = _wide(20_000, 10, spread=1.5), _wide(20_000, 11, spread=1.5)
    p, e = tp.two_prod(_t(a), _t(b))
    np.testing.assert_array_equal(p.numpy().astype(np.float64) + e.numpy(),
                                  a.astype(np.float64) * b)


def test_wide_sum_beats_naive():
    x = _wide(2_000, 12, spread=4.0, shape=(100,))
    ref = x.astype(np.float64).sum(axis=0)
    naive = np.add.reduce(x, axis=0, dtype=np.float32)  # sequential fp32
    wide = tp.wide_sum(_t(x), axis=0).numpy()
    assert np.abs(wide - ref).sum() < np.abs(naive - ref).sum() / 2


def test_wide_dot_beats_naive():
    a, b = _wide(100, 13, shape=(1_000,)), np.random.RandomState(14).randn(100, 1_000)
    b = b.astype(np.float32)
    ref = (a.astype(np.float64) * b).sum(axis=-1)
    naive = np.add.reduce(a * b, axis=-1)
    wide = tp.wide_dot(_t(a), _t(b)).numpy()
    assert np.abs(wide - ref).sum() <= np.abs(naive - ref).sum()


def test_table1_property_reduction_rmse():
    """Table 1 in miniature, as tests/test_precision.py: a GoogLeNet 3x3
    reduction (K = 1,728) has a lower RMSE through wide_dot than through a
    sequential fp32 sum."""
    rng = np.random.RandomState(2)
    x = rng.randn(64, 3 * 3 * 192).astype(np.float32)
    w = rng.randn(64, 3 * 3 * 192).astype(np.float32)
    ref = (x.astype(np.float64) * w).sum(axis=-1)
    naive = np.array([float(np.add.reduce(xi * wi)) for xi, wi in zip(x, w)]) - ref
    wide = tp.wide_dot(_t(x), _t(w)).numpy() - ref
    assert np.sqrt(np.mean(wide**2)) < np.sqrt(np.mean(naive**2)) / 1.7
