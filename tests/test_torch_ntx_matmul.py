"""The port's NTX matmul (``ops.matmul``, ``ntx_matmul``) against JAX's, on the CPU.

The same seeded numpy operands go through ``repro.kernels.ops.matmul(backend=
"interpret")`` (the Pallas kernel in interpret mode) and the port's
``ops.matmul``, which on CPU tensors runs the plain version of the kernel:
the shapes of ``tests/kernels/test_ntx_matmul.py`` in fp32 and bf16, plain
and compensated, at that file's tolerance (atol 2e-5 sqrt(k) fp32, 2e-2
sqrt(k) bf16, rtol 1e-2). Integer operands whose K tiles sum exactly and
whose total crosses 2**24 hold compensation to the exact result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ntx_matmul import ntx_matmul as jax_ntx_matmul
from repro_torch.kernels import ntx_matmul as mm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import matmul_ref, matmul_ref64

SHAPES = [
    (128, 128, 128),
    (128, 128, 512),
    (256, 128, 384),
    (64, 64, 64),
    (100, 70, 333),  # ragged: JAX pads, the port masks
    (8, 200, 40),
]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _operands(m, n, k, jdt, tdt, seed=None):
    rng = np.random.RandomState(m + n + k if seed is None else seed)
    ja = jnp.asarray(rng.randn(m, k), jdt)
    jb = jnp.asarray(rng.randn(k, n), jdt)
    # the JAX arrays' values, exact in float32, in the port's dtype
    ta = torch.from_numpy(np.array(ja, np.float32)).to(tdt)
    tb = torch.from_numpy(np.array(jb, np.float32)).to(tdt)
    return ja, jb, ta, tb


@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "comp"])
@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_matmul_matches_jax_interpret(m, n, k, dt, compensated):
    ja, jb, ta, tb = _operands(m, n, k, *DTYPES[dt])
    want = np.asarray(jops.matmul(ja, jb, backend="interpret", compensated=compensated))
    got = ops.matmul(ta, tb, compensated=compensated)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    tol = 2e-5 * np.sqrt(k) if dt == "f32" else 2e-2 * np.sqrt(k)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=1e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.matmul_ref(ja, jb)), atol=tol,
                               rtol=1e-2)
    np.testing.assert_allclose(got.numpy(), matmul_ref(ta, tb).numpy(), atol=tol, rtol=1e-2)


def test_compensated_not_worse_vs_fp64():
    """tests/kernels/test_ntx_matmul.py's case, on the port."""
    rng = np.random.RandomState(0)
    a = (rng.randn(128, 2048) * 10.0 ** rng.uniform(-2, 2, (128, 2048))).astype(np.float32)
    b = rng.randn(2048, 128).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = matmul_ref64(ta, tb).numpy()
    np.testing.assert_allclose(want, jref.matmul_ref64(a, b), rtol=1e-10)
    plain = ops.matmul(ta, tb).double().numpy()
    comp = ops.matmul(ta, tb, compensated=True).double().numpy()
    rms = lambda x: float(np.sqrt(np.mean(np.square(x - want))))  # noqa: E731
    assert rms(comp) <= rms(plain) * 1.001
    jcomp = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b), backend="interpret",
                                   compensated=True), np.float64)
    assert rms(comp) <= rms(jcomp) * 1.05


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_compensation_is_exact_where_plain_accumulation_rounds(dt):
    """Integers below 256 over K = 1,728 (Table 1's reduction), K tiles of
    128: every tile sums exactly in fp32, the totals cross 2**24. The
    compensated result is the fp64 result rounded once, as JAX's is; the
    plain-mode result, read through the same gate, is the control."""
    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(3)
    a = rng.randint(0, 256, (64, 1728)).astype(np.float32)
    b = rng.randint(0, 256, (1728, 32)).astype(np.float32)
    exact = (a.astype(np.float64) @ b).astype(np.float32)
    assert (exact > 2.0**24).all()
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    comp = ops.matmul(ta, tb, compensated=True).numpy()
    np.testing.assert_array_equal(comp, exact)
    jcomp = jops.matmul(jnp.asarray(a, jdt), jnp.asarray(b, jdt), backend="interpret",
                        compensated=True)
    np.testing.assert_array_equal(comp, np.asarray(jcomp))
    plain = ops.matmul(ta, tb).numpy()
    assert (plain != exact).mean() > 0.25  # the control is rejected


def test_out_dtype():
    a = torch.ones((128, 128), dtype=torch.bfloat16)
    out = ops.matmul(a, a, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), 128.0)
    ja, jb, ta, tb = _operands(100, 70, 333, jnp.float32, torch.float32)
    want = jops.matmul(ja, jb, backend="interpret", out_dtype=jnp.bfloat16, compensated=True)
    got = ops.matmul(ta, tb, out_dtype=torch.bfloat16, compensated=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2 * np.sqrt(333), rtol=1e-2)


@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "comp"])
def test_ntx_matmul_plans_tiles_as_jax(compensated):
    """The TPU kernel's entry: blocks from plan_matmul_tiles (bk = 384 here)."""
    ja, jb, ta, tb = _operands(256, 128, 384, jnp.float32, torch.float32)
    want = jax_ntx_matmul(ja, jb, compensated=compensated, interpret=True)
    got = mm.ntx_matmul(ta, tb, compensated=compensated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5 * np.sqrt(384),
                               rtol=1e-2)
    want = jax_ntx_matmul(ja, jb, compensated=compensated, block_k=128, interpret=True)
    got = mm.ntx_matmul(ta, tb, compensated=compensated, block_k=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5 * np.sqrt(384),
                               rtol=1e-2)


@pytest.mark.parametrize("block_k", [64, 576])
def test_block_k_matches_jax_bit_for_bit_on_exact_tiles(block_k):
    """Integers below 128 over K = 4,608: every K tile (at most 576 wide)
    sums exactly in fp32 and the totals cross 2**24, so both packages join
    the same tile sums in the same order. Plain mode rounds at the same
    joins and compensated mode is exact: bit for bit with JAX's interpret
    kernel at that ``block_k``, and with a ragged last tile too."""
    rng = np.random.RandomState(5)
    a = rng.randint(0, 128, (32, 4608)).astype(np.float32)
    b = rng.randint(0, 128, (4608, 16)).astype(np.float32)
    exact = (a.astype(np.float64) @ b).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for comp in (False, True):
        want = jax_ntx_matmul(jnp.asarray(a), jnp.asarray(b), compensated=comp,
                              block_k=block_k, interpret=True)
        got = mm.ntx_matmul(ta, tb, compensated=comp, block_k=block_k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), exact)
    ragged = mm.tiled_matmul(ta, tb, block_k=block_k + 36, compensated=True)
    np.testing.assert_array_equal(ragged.numpy(), exact)


def test_strided_views_and_refusals():
    g = np.random.RandomState(6)
    a = torch.from_numpy(g.randn(130, 257).astype(np.float32)).T  # (257, 130) view
    b = torch.from_numpy(g.randn(45, 130).astype(np.float32)).T  # (130, 45) view
    torch.testing.assert_close(ops.matmul(a, b), ops.matmul(a.contiguous(), b.contiguous()),
                               rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="bad shapes"):
        ops.matmul(torch.ones(4, 5), torch.ones(4, 5))
    with pytest.raises(TypeError, match="out_dtype"):
        ops.matmul(torch.ones(4, 5), torch.ones(5, 4), out_dtype=torch.float16)
    with pytest.raises(ValueError, match="must tile"):
        mm.ntx_matmul(torch.ones(100, 333), torch.ones(333, 70), block_k=64)
    with pytest.raises(ValueError, match="on the CPU or all on one CUDA"):
        ops.matmul(torch.ones(4, 5), torch.ones(5, 4, device="meta"))
