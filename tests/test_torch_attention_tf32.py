"""The fp32 tensor-core flash-attention kernel's design (3xTF32), on the CPU.

``csrc/flash_attention_tf32.cu`` runs only on the card. Its arithmetic is
emulated here in plain PyTorch (``flash_attention_tf32.emulate``: 64-key
tiles, each fp32 operand split into ``hi = tf32_rn(x)`` and ``lo =
tf32_rn(x - hi)``, per k8 slice lo·hi + hi·lo + hi·hi summed from zero and
added to the running sum) on inputs made with numpy from a seed, and held
against JAX's Pallas kernel in interpret mode at the fp32 band of
``chip_smoke.py`` (ATTN_F32: atol 2e-5, rtol 1e-3), and through its RMS
gate: the RMS error against the fp64 attention at most 1.05 x the plain
version's. The 1xTF32 product (hi·hi alone, ``terms=1``) must break that
gate. The wrapper's choice of kernel, the operand rules, the key order of a
``p v`` slice and the kernel's shared memory are pure functions, tested
here without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_tf32 as tf32
from repro_torch.kernels.ref import attention_ref

ATTN_F32 = {"atol": 2e-5, "rtol": 1e-3}  # chip_smoke.py's fp32 band
MM_RMS = 1.05  # chip_smoke.py's RMS gate
CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window): GQA at both head dims, a
    # window over Skv != Sq, a KV tail (400 = 6 x 64 + 16), non-causal
    (1, 4, 2, 256, 256, 64, True, None),
    (1, 4, 2, 256, 256, 128, True, None),
    (1, 4, 4, 128, 384, 64, True, 128),
    (1, 2, 1, 448, 400, 64, True, None),
    (2, 2, 1, 128, 128, 128, False, None),
]
IDS = [f"b{c[0]}-h{c[1]}/{c[2]}-s{c[3]}/{c[4]}-d{c[5]}-{'c' if c[6] else 'nc'}-w{c[7]}"
       for c in CASES]
# the RMS gate: the shapes chip_smoke.py gates at (a KV tail of 600, GQA at
# D 128, the Qwen head dim), cut to S <= 600, and a window of 128
RMS_CASES = [
    (1, 4, 4, 512, 512, 64, True, None),
    (1, 2, 2, 600, 600, 64, True, None),
    (1, 4, 1, 384, 384, 128, True, None),
    (1, 4, 2, 512, 512, 64, True, 128),
    (1, 2, 2, 256, 256, 128, False, None),
]
RMS_IDS = [f"h{c[1]}/{c[2]}-s{c[3]}-d{c[5]}-{'c' if c[6] else 'nc'}-w{c[7]}" for c in RMS_CASES]


def _inputs(b, hq, hkv, sq, skv, d, seed, std=0.3):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(b, h, s, d) * std).astype(np.float32)
                 for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))


def _rms(x) -> float:
    return float(x.double().square().mean().sqrt())


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", CASES, ids=IDS)
def test_emulation_matches_jax_kernel_f32(b, hq, hkv, sq, skv, d, causal, window):
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d)
    want = np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                          window=window, block_q=64, block_kv=64,
                                          interpret=True))
    got = tf32.emulate(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **ATTN_F32)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", RMS_CASES, ids=RMS_IDS)
def test_rms_gate_passes_three_terms_and_rejects_one(b, hq, hkv, sq, skv, d, causal, window):
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, hq, hkv, sq, skv, d, seed=11))
    kw = {"causal": causal, "window": window}
    ref = attention_ref(q, k, v, compute_dtype=torch.float64, **kw)
    base = _rms(fa.flash_attention_torch(q, k, v, **kw).double() - ref)
    three = _rms(tf32.emulate(q, k, v, **kw).double() - ref) / base
    one = _rms(tf32.emulate(q, k, v, terms=1, **kw).double() - ref) / base
    assert three <= MM_RMS  # the gate of chip_smoke.py
    assert one > 100 * MM_RMS  # hi·hi alone keeps about 11 bits of each product


def test_one_term_also_breaks_the_band():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 256, 256, 64, seed=3))
    want = fa.flash_attention_torch(q, k, v)
    one = tf32.emulate(q, k, v, terms=1)
    band = ((one - want).abs() / (ATTN_F32["atol"] + ATTN_F32["rtol"] * want.abs())).max()
    assert float(band) > 1


def test_emulation_rows_with_no_visible_key_are_zero():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 256, 64, 64, seed=5))
    got = tf32.emulate(q, k, v, causal=True, window=32)
    assert not bool(got[:, :, 95:].any())
    assert bool((got[:, :, :95].abs().amax(dim=-1) > 0).all())


def test_emulate_refuses_other_term_counts():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 1, 64, 64, 64, seed=0))
    with pytest.raises(ValueError, match="terms must be 1 or 3"):
        tf32.emulate(q, k, v, terms=2)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_entry_sends_fp32_at_64_and_128_to_the_tensor_cores(d):
    want = tf32.ENTRY if d in tf32.HEAD_DIMS else "flash_attention_f32"
    assert fa.entry(torch.float32, d) == want
    assert fa.ENTRIES[want] == (tf32.LIB if d in tf32.HEAD_DIMS else "flash_attention")


def test_launch_refuses_the_tf32_entry_for_other_dtypes_and_head_dims():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(1, 2, 2, 64, 64, 64, seed=1))
    with pytest.raises(ValueError, match="takes fp32 at head dims"):
        fa.launch(tf32.ENTRY, q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 64, 64, 32, seed=1))
    with pytest.raises(ValueError, match="takes fp32 at head dims"):
        fa.launch(tf32.ENTRY, q, k, v)


def test_operand_strides_take_views_and_refuse_what_the_producers_cannot_read():
    base = torch.zeros(2, 256, 16, 64)
    view = base.transpose(1, 2)  # attention_block's (B, S, H, D) -> (B, H, S, D) view
    assert tf32.operand_strides(view, "v") == (256 * 16 * 64, 64, 16 * 64, 1)
    assert tf32.operand_strides(view.contiguous(), "v") == (16 * 256 * 64, 256 * 64, 64, 1)
    wide = torch.zeros(1, 2, 128, 66)[..., :64]  # rows of 264 bytes
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tf32.operand_strides(wide, "k")
    assert tf32.operand_strides(torch.zeros(1, 2, 128, 68)[..., :64], "k")[2] == 68
    shifted = torch.zeros(1 * 2 * 128 * 64 + 1)[1:].view(1, 2, 128, 64)
    assert shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        tf32.operand_strides(shifted, "q")
    with pytest.raises(ValueError, match="unit last stride"):
        tf32.operand_strides(base.permute(0, 2, 3, 1), "q")  # D strided by 16 heads


@pytest.mark.parametrize("d", tf32.HEAD_DIMS)
def test_kernel_shared_memory_fits_one_block(d):
    assert tf32.smem_bytes(d) <= fa.MAX_SMEM
    assert (tf32.warpgroups(d), tf32.stages(d), tf32.block_q(d)) == (
        (2, 2, 128) if d == 64 else (1, 1, 64))
    assert tf32.smem_bytes(64) == 197_704 and tf32.smem_bytes(128) == 197_672


@pytest.mark.parametrize("d", tf32.HEAD_DIMS)
def test_setmaxnreg_split_fits_the_registers_ptxas_gives_the_block(d):
    """Two consumer warpgroups (D 64) take 208 registers a thread from a
    producer left with 88, so the block of 384 must be built with 168 a
    thread, which the register file holds; one warpgroup (D 128) moves none."""
    need = tf32.registers_needed(d)
    assert need == (168 if d == 64 else 0)
    threads = 128 * (tf32.warpgroups(d) + 1)
    assert need * threads <= 65_536
    if need:
        assert threads * need >= 128 * (tf32.PRODUCER_REGS + 2 * tf32.CONSUMER_REGS)


def test_pv_key_order_matches_the_score_fragment():
    """Thread t of a row holds the scores of keys 2t and 2t + 1 of each group
    of 8 (the wgmma accumulator); tf32's A fragment takes columns t and t + 4.
    The order is a permutation of the 8 keys, so a slice sums the same keys."""
    order = tf32.pv_key_order()
    assert sorted(order) == list(range(8))
    for t in range(4):
        assert (order[t], order[t + 4]) == (2 * t, 2 * t + 1)


def test_key_order_changes_no_slice_sum_in_exact_arithmetic():
    rng = np.random.RandomState(2)
    p = torch.from_numpy(rng.randn(16, 8)).double()
    v = torch.from_numpy(rng.randn(8, 64)).double()
    order = tf32.pv_key_order()
    torch.testing.assert_close(p[:, order] @ v[order], p @ v, rtol=1e-14, atol=1e-14)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 64, 64, 64, seed=3))
    fa.COUNTER.reset()
    got = fa.flash_attention(q, k, v)
    assert (fa.COUNTER.launches, fa.COUNTER.plain_calls, fa.COUNTER.entries) == (0, 1, {})
    assert torch.equal(got, fa.flash_attention_torch(q, k, v))


if __name__ == "__main__":  # the RMS ratios behind the gate, printed
    for case in RMS_CASES:
        *shape, causal, window = case
        q, k, v = (torch.from_numpy(a) for a in _inputs(*shape, seed=11))
        kw = {"causal": causal, "window": window}
        ref = attention_ref(q, k, v, compute_dtype=torch.float64, **kw)
        base = _rms(fa.flash_attention_torch(q, k, v, **kw).double() - ref)
        print(f"{case}: RMS vs fp64 over the plain version's, 3xTF32 "
              f"{_rms(tf32.emulate(q, k, v, **kw).double() - ref) / base:.4f}, 1xTF32 "
              f"{_rms(tf32.emulate(q, k, v, terms=1, **kw).double() - ref) / base:.1f}")
