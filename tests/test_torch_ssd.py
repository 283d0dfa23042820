"""The port's SSD scan against the JAX package's, on the CPU.

The port's plain chunked version (what ``ssd_scan`` runs on CPU tensors)
and its sequential ``ssd_ref`` are held against ``repro.kernels.ops.ssd``
with the Pallas kernel in interpret mode and against ``repro.kernels.ref
.ssd_ref``, on the shapes of ``tests/kernels/test_ssd_scan.py`` (G 1, 2
and 4), at 3e-5 of max|y| (that file's band). Inputs are made with numpy
from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ssd_scan
from repro_torch.kernels.ref import ssd_ref

CASES = [
    # (B, H, G, S, P, N, chunk)
    (2, 4, 2, 256, 32, 32, 64),
    (1, 2, 1, 128, 64, 128, 128),
    (1, 4, 4, 192, 16, 32, 64),
    (1, 1, 1, 64, 8, 16, 32),
]
TOL = 3e-5  # of max|y|, the band of the JAX kernel sweep


def _mk(bs, h, g, s, p, n, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(bs, h, s, p) * 0.5).astype(np.float32)
    la = (-np.abs(rng.rand(bs, h, s)) * 0.5).astype(np.float32)
    b = (rng.randn(bs, g, s, n) * 0.3).astype(np.float32)
    c = (rng.randn(bs, g, s, n) * 0.3).astype(np.float32)
    return x, la, b, c


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("jax_route", ["interpret", "sequential"])
@pytest.mark.parametrize("bs,h,g,s,p,n,chunk", CASES)
def test_plain_ssd_matches_jax(bs, h, g, s, p, n, chunk, jax_route):
    arrs = _mk(bs, h, g, s, p, n, seed=s + p)
    if jax_route == "interpret":
        want = jops.ssd(*map(jnp.asarray, arrs), chunk=chunk, backend="interpret")
    else:
        want = jref.ssd_ref(*map(jnp.asarray, arrs))
    ssd_scan.COUNTER.reset()
    got = ops.ssd(*_torch(*arrs), chunk=chunk)
    assert (ssd_scan.COUNTER.launches, ssd_scan.COUNTER.plain_calls) == (0, 1)
    assert got.shape == (bs, h, s, p) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("bs,h,g,s,p,n,chunk", CASES)
def test_sequential_ref_matches_jax(bs, h, g, s, p, n, chunk):
    arrs = _mk(bs, h, g, s, p, n, seed=s + p + 1)
    want = jref.ssd_ref(*map(jnp.asarray, arrs))
    got = ssd_ref(*_torch(*arrs))
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("bs,h,g,s,p,n,chunk", CASES[:2])
def test_plain_ssd_bf16_matches_jax_interpret(bs, h, g, s, p, n, chunk):
    """bf16 operands, fp32 inside, y rounded once: within one bf16 ulp."""
    arrs = _mk(bs, h, g, s, p, n, seed=s)
    x, la, b, c = arrs
    want = jops.ssd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(la),
                    jnp.asarray(b, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16),
                    chunk=chunk, backend="interpret")
    tx, tla, tb, tc = _torch(*arrs)
    got = ssd_scan.ssd_scan(tx.bfloat16(), tla, tb.bfloat16(), tc.bfloat16(), chunk=chunk)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= 1e-2


def test_strong_decay_stays_finite():
    """la = -0.1 * A, A up to 48: exp above the diagonal overflows to inf.

    The plain version selects 0 there, as the JAX kernel does; a product
    with a 0/1 mask would give NaN.
    """
    bs, h, g, s, p, n, chunk = 1, 48, 1, 256, 8, 16, 128
    x, _, b, c = _mk(bs, h, g, s, p, n, seed=11)
    la = np.broadcast_to(-0.1 * np.arange(1, h + 1, dtype=np.float32)[None, :, None],
                         (bs, h, s)).copy()
    cum = np.cumsum(la[0, -1, :chunk])
    with np.errstate(over="ignore"):  # i < j: the masked half overflows
        assert np.isinf(np.exp(np.float32(cum[0] - cum[-1])))
    got = ssd_scan.ssd_scan(*_torch(x, la, b, c), chunk=chunk)
    assert bool(torch.isfinite(got).all())
    want = jops.ssd(*map(jnp.asarray, (x, la, b, c)), chunk=chunk, backend="interpret")
    assert _rel(got.numpy(), want) <= TOL
    assert _rel(got.numpy(), ssd_ref(*_torch(x, la, b, c)).numpy()) <= TOL


def test_plain_ssd_reads_transposed_views():
    """ssm_block passes (B,S,H,P) -> (B,H,S,P) views; values, not layout, count."""
    x, la, b, c = _torch(*_mk(2, 8, 2, 128, 16, 32, seed=4))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (x, la, b, c)]
    assert not any(v.is_contiguous() for v in views)
    torch.testing.assert_close(ssd_scan.ssd_scan(*views, chunk=32),
                               ssd_scan.ssd_scan(x, la, b, c, chunk=32), rtol=0, atol=0)


def test_chunk_clamps_to_sequence_and_must_divide_it():
    x, la, b, c = _torch(*_mk(1, 2, 1, 48, 8, 16, seed=5))
    y = ssd_scan.ssd_scan(x, la, b, c, chunk=128)  # chunk = min(128, 48)
    assert _rel(y.numpy(), ssd_ref(x, la, b, c).numpy()) <= TOL
    with pytest.raises(ValueError):
        ssd_scan.ssd_scan(x, la, b, c, chunk=32)
    with pytest.raises(ValueError):  # 2 heads in 3 groups
        ssd_scan.ssd_scan(x, la, torch.cat([b, b, b], 1), torch.cat([c, c, c], 1), chunk=16)


def test_wrapper_raises_on_mixed_or_unsupported_devices():
    x, la, b, c = _torch(*_mk(1, 2, 1, 64, 8, 16, seed=6))
    with pytest.raises(ValueError):
        ssd_scan.ssd_scan(x, la.to("meta"), b, c, chunk=32)
    with pytest.raises(ValueError):
        ssd_scan.ssd_scan(*(t.to("meta") for t in (x, la, b, c)), chunk=32)


def test_kernel_shared_memory_fits_the_full_width_block():
    need = ssd_scan.smem_bytes(64, 128, 128)  # mamba2_780m: P 64, N 128, chunk 128
    assert 48 * 1024 < need <= ssd_scan.MAX_SMEM
