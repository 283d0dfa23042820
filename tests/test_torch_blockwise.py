"""The port's blockwise attention and chunked SSD routes against the JAX package's.

``repro_torch.kernels.ops.attention(backend="xla")`` and
``ops.ssd(backend="xla")`` — the routes the training step and autograd go
through — against ``repro.kernels.ops`` on the same numpy inputs, outputs and
gradients (``torch.autograd`` against ``jax.grad`` of the same cotangent
product). Attention: causal and windowed, GQA, a padded last KV block,
``q_offset`` / ``kv_valid_len``. SSD: ``y``, the final state and the
gradients, with and without ``h0`` (``_ssd_chunked_xla`` on both sides).
fp32 at rtol 1e-5 / atol 1e-6; bf16 at the bf16 band of
``tests/kernels/test_flash_attention.py`` (atol 2e-2). Each atol is of
``max(1, max|want|)``, as JAX's SSD tests scale by the output's maximum: a
gradient of size 4 that cancels to near zero carries fp32 rounding of its
terms (about 1.2e-6 where XLA and PyTorch sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

F32 = {"rtol": 1e-5, "atol": 1e-6}
BF16 = {"rtol": 0.0, "atol": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32, F32), "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}

# (B, Hq, Hkv, Sq, Skv, D, causal, window, block_kv, q_offset, kv_valid_len)
ATTN_CASES = {
    "causal_gqa": (2, 4, 2, 64, 64, 16, True, None, 16, 0, None),
    "windowed": (1, 4, 4, 64, 64, 16, True, 24, 16, 0, None),
    "padded_last_block": (1, 2, 1, 40, 40, 16, True, None, 16, 0, None),
    "full_gqa_padded": (2, 4, 1, 32, 48, 32, False, None, 32, 0, None),
    "offset_valid_len": (1, 4, 2, 8, 64, 16, True, None, 16, 20, 28),
    "offset_window": (2, 2, 1, 4, 48, 16, True, 12, 16, 30, 34),
}


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=tol["rtol"], atol=tol["atol"] * scale)


def _attn_inputs(case, seed=0):
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, sq, d).astype(np.float32) * 0.3
    k = rng.randn(b, hkv, skv, d).astype(np.float32) * 0.3
    v = rng.randn(b, hkv, skv, d).astype(np.float32) * 0.3
    cot = rng.randn(b, hq, sq, d).astype(np.float32)
    return q, k, v, cot


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_blockwise_attention_and_grads_match_jax(name, dtype):
    case = ATTN_CASES[name]
    causal, window, block_kv, q_offset, kv_valid_len = case[6:]
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, cot = _attn_inputs(case)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_valid_len=kv_valid_len,
              block_kv=block_kv)

    def jloss(q, k, v):
        o = jops.attention(q, k, v, backend="xla", **kw)
        return jnp.sum(o.astype(jnp.float32) * cot), o

    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    to = ops.attention(tq, tk, tv, backend="xla", **kw)
    assert to.dtype == tdt and to.shape == tq.shape
    tgrads = torch.autograd.grad((to.float() * torch.from_numpy(cot)).sum(), (tq, tk, tv))
    _close(to, jo, tol)
    for got, want in zip(tgrads, jgrads):
        assert got.dtype == tdt
        _close(got, want, tol)


def test_blockwise_route_runs_decode_offsets_the_kernel_route_refuses():
    q, k, v, _ = (torch.from_numpy(a) for a in _attn_inputs(ATTN_CASES["offset_valid_len"]))
    with pytest.raises(NotImplementedError, match="backend='xla'"):
        ops.attention(q, k, v, q_offset=20, kv_valid_len=28)
    with pytest.raises(ValueError, match="backend must be one of"):
        ops.attention(q, k, v, backend="tpu")
    # a row whose keys are all masked gives zeros, not NaN
    o = ops.attention(q, k, v, q_offset=0, kv_valid_len=0, backend="xla", block_kv=16)
    assert torch.equal(o, torch.zeros_like(o))


# (B, H, G, S, P, N, chunk)
SSD_CASES = {"one_group": (2, 4, 1, 64, 16, 16, 16), "two_groups": (1, 4, 2, 48, 8, 16, 16)}


def _ssd_inputs(case, seed=0):
    b, h, g, s, p, n, _ = case
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, s, p).astype(np.float32) * 0.5
    la = -rng.rand(b, h, s).astype(np.float32) * 0.5  # tests/kernels/test_ssd_scan.py's
    bb = rng.randn(b, g, s, n).astype(np.float32) * 0.3
    c = rng.randn(b, g, s, n).astype(np.float32) * 0.3
    h0 = rng.randn(b, h, p, n).astype(np.float32) * 0.2
    ycot = rng.randn(b, h, s, p).astype(np.float32)
    hcot = rng.randn(b, h, p, n).astype(np.float32)
    return (x, la, bb, c), h0, ycot, hcot


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(SSD_CASES))
def test_chunked_ssd_state_and_grads_match_jax(name, dtype, with_h0):
    case = SSD_CASES[name]
    chunk = case[-1]
    jdt, tdt, tol = DTYPES[dtype]
    ins, h0, ycot, hcot = _ssd_inputs(case)

    def jloss(x, la, b, c, h0):
        if h0 is None:
            y, h = jops.ssd(x, la, b, c, chunk=chunk, backend="xla", return_state=True)
        else:
            y, h = jax.jit(jops._ssd_chunked_xla, static_argnames="chunk")(
                x, la, b, c, chunk=chunk, h0=h0)
        return jnp.sum(y.astype(jnp.float32) * ycot) + jnp.sum(h * hcot), (y, h)

    jins = tuple(jnp.asarray(a, jdt) for a in ins)
    jh0 = jnp.asarray(h0) if with_h0 else None
    argnums = (0, 1, 2, 3, 4) if with_h0 else (0, 1, 2, 3)
    (_, (jy, jh)), jgrads = jax.value_and_grad(jloss, argnums=argnums, has_aux=True)(
        *jins, jh0)

    tins = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in ins]
    th0 = torch.from_numpy(h0).requires_grad_(True) if with_h0 else None
    if with_h0:
        ty, th = ops._ssd_chunked_xla(*tins, chunk=chunk, h0=th0)
    else:
        ty, th = ops.ssd(*tins, chunk=chunk, backend="xla", return_state=True)
    assert ty.dtype == tdt and th.dtype == torch.float32
    loss = (ty.float() * torch.from_numpy(ycot)).sum() + (th * torch.from_numpy(hcot)).sum()
    tgrads = torch.autograd.grad(loss, tins + ([th0] if with_h0 else []))
    _close(ty, jy, tol)
    _close(th, jh, tol)
    for got, want in zip(tgrads, jgrads):
        _close(got, want, tol)


def test_ssd_auto_route_without_state_is_the_plain_kernel_version():
    ins, _, _, _ = _ssd_inputs(SSD_CASES["one_group"])
    t = [torch.from_numpy(a) for a in ins]
    auto = ops.ssd(*t, chunk=16)
    xla = ops.ssd(*t, chunk=16, backend="xla")
    np.testing.assert_allclose(auto.numpy(), xla.numpy(), **F32)
    y, h = ops.ssd(*t, chunk=16, return_state=True)  # return_state takes the chunked route
    assert torch.equal(y, xla) and h.shape == (2, 4, 16, 16)


def _c7_inputs():
    """ROADMAP C7's case: one 64-token chunk at la = -1.6, so the masked
    decays exp(cum_i - cum_j), j > i, reach exp(100) and overflow fp32."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 2, 64, 8).astype(np.float32)
    b = rng.randn(1, 1, 64, 8).astype(np.float32)
    c = rng.randn(1, 1, 64, 8).astype(np.float32)
    return x, np.full((1, 2, 64), -1.6, np.float32), b, c


def test_chunked_ssd_grads_stay_finite_past_the_exp_range():
    """d la of the chunked route at la = -1.6 is finite and matches the same
    route in fp64 (no overflow there) at rtol 1e-5 / atol 1e-6 · max. The
    reference's unmasked form (JAX's route) gives NaN on these inputs: the
    control that shows the case reaches the overflow."""
    x, la, b, c = _c7_inputs()
    grads = {}
    for dt in (torch.float32, torch.float64):
        tla = torch.from_numpy(la).to(dt).requires_grad_(True)
        y = ops.ssd(*(torch.from_numpy(a).to(dt) for a in (x,)), tla,
                    torch.from_numpy(b).to(dt), torch.from_numpy(c).to(dt),
                    chunk=64, backend="xla")
        grads[dt], = torch.autograd.grad(y.sum(), tla)
    got, want = grads[torch.float32], grads[torch.float64]
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    _close(got, want.numpy(), F32)

    jgrad = jax.grad(lambda la: jops.ssd(jnp.asarray(x), la, jnp.asarray(b), jnp.asarray(c),
                                         chunk=64, backend="xla").sum())(jnp.asarray(la))
    assert bool(jnp.isnan(jgrad).all())
