"""The port's flash attention against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
port's plain version (what its wrapper runs for CPU tensors) is held
against JAX's Pallas kernel in interpret mode and against JAX's dense
``attention_ref``, over the shapes of ``tests/kernels/test_flash_attention.py``
(GQA, sliding window, Skv != Sq, non-causal, D 32 to 128) plus the D-256
MQA window shape of recurrentgemma and rows with no visible key: fp32 at
atol 2e-5 / rtol 1e-3 (the band of that file), bf16 at atol 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window): tests/kernels/test_flash_attention.py
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 4, 256, 256, 64, True, None),
    (1, 4, 4, 128, 384, 64, True, 128),
    (2, 2, 1, 128, 128, 128, False, None),
    (1, 2, 2, 64, 192, 32, True, 64),
    # MQA with a sliding window at recurrentgemma's head dim
    (1, 2, 1, 128, 128, 256, True, 64),
    # rows >= 95 see no key (j <= i - 32 for every j < 64): they must give 0
    (1, 2, 1, 256, 64, 16, True, 32),
]
IDS = [f"b{c[0]}-h{c[1]}/{c[2]}-s{c[3]}/{c[4]}-d{c[5]}-{'c' if c[6] else 'nc'}-w{c[7]}"
       for c in CASES]


def _inputs(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, hq, sq, d) * 0.3).astype(np.float32)
    k = (rng.randn(b, hkv, skv, d) * 0.3).astype(np.float32)
    v = (rng.randn(b, hkv, skv, d) * 0.3).astype(np.float32)
    return q, k, v


def _jax_kernel(q, k, v, causal, window, dtype=jnp.float32, block_kv=64):
    out = jax_flash_attention(jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
                              causal=causal, window=window, block_q=64, block_kv=block_kv,
                              interpret=True)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", CASES, ids=IDS)
def test_plain_matches_jax_kernel_and_ref(b, hq, hkv, sq, skv, d, causal, window):
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d)
    want_kernel = _jax_kernel(q, k, v, causal, window)
    want_ref = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal, window=window))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    fa.COUNTER.reset()
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert (fa.COUNTER.launches, fa.COUNTER.plain_calls) == (0, 1)
    assert got.shape == (b, hq, sq, d) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want_kernel, atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=1e-3)
    port_ref = ref.attention_ref(tq, tk, tv, causal=causal, window=window).numpy()
    np.testing.assert_allclose(port_ref, want_ref, atol=2e-5, rtol=1e-3)


def test_rows_with_no_visible_key_are_exactly_zero():
    q, k, v = _inputs(1, 2, 1, 256, 64, 16, seed=7)
    want = _jax_kernel(q, k, v, True, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=True, window=32)
    dense = ref.attention_ref(tq, tk, tv, causal=True, window=32)
    for out in (got.numpy(), dense.numpy(), want):
        assert not out[:, :, 95:].any()
        assert np.abs(out[:, :, :95]).min(axis=-1).max() > 0


@pytest.mark.parametrize("block_kv", [64, 512])
def test_kv_tail_block(block_kv):
    """Sq = Skv = 640: the plain version's last KV block of 512 holds 128 keys;
    JAX's kernel at ``block_kv`` 512 pads the same tail, at 64 it has none."""
    q, k, v = _inputs(1, 2, 2, 640, 640, 32, seed=11)
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    want_kernel = _jax_kernel(q, k, v, True, None, block_kv=block_kv)
    got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(got, want_kernel, atol=2e-5, rtol=1e-3)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[5]], ids=[IDS[0], IDS[2], IDS[5]])
def test_plain_matches_jax_kernel_bf16(case):
    b, hq, hkv, sq, skv, d, causal, window = case
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, seed=0)
    want = _jax_kernel(q, k, v, causal, window, jnp.bfloat16)
    got = ops.attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=causal,
                        window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_sm_scale_and_strided_operands():
    """An explicit sm_scale, and the transposed (B, S, H, D) views attention_block passes."""
    q, k, v = _inputs(2, 4, 2, 128, 128, 32, seed=5)
    want = _jax_kernel(q, k, v, True, None)  # default 1/sqrt(D)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).contiguous().transpose(1, 2)
                  for a in (q, k, v))
    assert not tv.is_contiguous()
    got = ops.attention(tq, tk, tv, sm_scale=32**-0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-3)
    half = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          sm_scale=0.5, interpret=True))
    np.testing.assert_allclose(ops.attention(tq, tk, tv, sm_scale=0.5).numpy(), half,
                               atol=2e-5, rtol=1e-3)


def test_decode_offsets_are_not_ported():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 1, 64, 16, seed=1))
    with pytest.raises(NotImplementedError, match="decode_attention_block"):
        ops.attention(q, k, v, q_offset=5)
    with pytest.raises(NotImplementedError, match="decode_attention_block"):
        ops.attention(q, k, v, kv_valid_len=6)


def test_wrapper_refuses_bad_operands():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 64, 64, 16, seed=2))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fa.flash_attention(q, k.to("meta"), v)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q[:, :3], k, v)  # 3 q heads, 2 kv heads
    with pytest.raises(ValueError, match="bad shapes"):
        fa.flash_attention(q, k, v[:, :, :48])
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention(q, k[..., :8], v[..., :8])


def test_kernel_shared_memory_fits_every_head_dim():
    assert fa.HEAD_DIMS == (16, 32, 64, 128, 256)
    assert fa.smem_bytes(256) == 214_528
    assert all(fa.smem_bytes(d) <= fa.MAX_SMEM for d in fa.HEAD_DIMS)
