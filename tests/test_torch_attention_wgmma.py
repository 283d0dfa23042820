"""The bf16 tensor-core flash-attention kernel's design, on the CPU.

``csrc/flash_attention_wgmma.cu`` runs only on the card. Its numerics are
emulated here in plain PyTorch (:func:`_kernel_numerics`: 64-key tiles,
scores in fp32 from bf16 operands and kept in the log2 domain, p split into
two bf16 terms ``p_hi = bf16(p)``, ``p_lo = bf16(p - p_hi)`` with fp32
sums, l summed from the fp32 p) on inputs made with numpy from a seed, and
held against JAX's Pallas kernel in interpret mode at the bf16 tolerance of
``test_torch_attention.py::test_plain_matches_jax_kernel_bf16`` (atol 2e-2),
and through ``chip_smoke.py``'s rounded-once gate: at most 1 % of o's
elements may differ from the fp64 attention rounded once to bf16. One bf16
term of p (the ``p_bf16`` control) must break that gate. The wrapper's
choice of kernel, TMA's operand rules and the kernel's shared memory are
pure functions, tested here without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_wgmma as wgmma
from repro_torch.kernels.ref import rounded_once_share

LOG2E = 1.4426950408889634
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
# the rounded-once gate at larger sizes (S <= 512), std 0.3 and 1.0
SHARE_CASES = [
    (1, 4, 2, 512, 512, 64, True, None, 0.3),
    (1, 4, 2, 512, 512, 128, True, None, 0.3),
    (1, 2, 2, 512, 512, 64, True, 128, 0.3),
    (1, 4, 4, 400, 400, 64, True, None, 1.0),
    (1, 4, 2, 256, 256, 128, False, None, 1.0),
]


def _inputs(b, hq, hkv, sq, skv, d, seed, std=0.3):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(b, h, s, d) * std).astype(np.float32)
                 for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))


def _kernel_numerics(q, k, v, *, causal=True, window=None, terms=2, bkv=wgmma.BKV):
    """The kernel's arithmetic in plain PyTorch: bf16 q, k, v -> bf16 o."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = torch.tensor(d**-0.5 * LOG2E, dtype=torch.float32)  # folded into one fp32 factor
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    kf, vf = k.float(), v.float()
    rows = torch.arange(sq)[:, None]
    m = torch.full((b, hkv, hq // hkv, sq, 1), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, sq, d))
    for k0 in range(0, skv, bkv):
        kb, vb = kf[:, :, None, k0:k0 + bkv], vf[:, :, None, k0:k0 + bkv]
        s = (qf @ kb.transpose(-1, -2)) * scale
        cols = k0 + torch.arange(kb.shape[3])[None, :]
        mask = torch.ones((sq, kb.shape[3]), dtype=torch.bool)
        if causal:
            mask &= cols <= rows
        if window is not None:
            mask &= cols > rows - window
        s = torch.where(mask, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        none = m_new <= fa.NEG_INF / 2
        p = torch.exp2(s - torch.where(none, 0.0, m_new))
        alpha = torch.where(none, 0.0, torch.exp2(m - m_new))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vb
        if terms == 2:
            pv = pv + (p - p_hi).bfloat16().float() @ vb
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)).reshape(b, hq, sq, d).bfloat16()


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", CASES, ids=IDS)
def test_two_term_p_matches_jax_kernel_bf16(b, hq, hkv, sq, skv, d, causal, window):
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d)
    want = np.asarray(jax_flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal, window=window,
        block_q=64, block_kv=64, interpret=True), np.float32)
    got = _kernel_numerics(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=causal,
                           window=window)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,std", SHARE_CASES)
def test_rounded_once_share_passes_two_terms_and_rejects_one(b, hq, hkv, sq, skv, d, causal,
                                                              window, std):
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(b, hq, hkv, sq, skv, d, seed=7, std=std))
    kw = {"causal": causal, "window": window}
    plain = rounded_once_share(fa.flash_attention_torch(q, k, v, **kw), q, k, v, **kw)
    two = rounded_once_share(_kernel_numerics(q, k, v, **kw), q, k, v, **kw)
    one = rounded_once_share(_kernel_numerics(q, k, v, terms=1, **kw), q, k, v, **kw)
    assert plain <= 1e-3  # p in fp32: a few elements in ten thousand
    assert two <= 1e-2  # the gate of chip_smoke.py (ROUNDED_ONCE)
    assert one > 1e-2  # p rounded to bf16 once: the control fails it


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_entry_follows_dtype_and_head_dim(dtype, d):
    want = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}[dtype]
    if d in (64, 128):
        want = {torch.float32: "flash_attention_f32_tf32",
                torch.bfloat16: "flash_attention_bf16_wgmma"}[dtype]
    assert fa.entry(dtype, d) == want
    lib = {"flash_attention_f32_tf32": "flash_attention_tf32",
           "flash_attention_bf16_wgmma": "flash_attention_wgmma"}.get(want, "flash_attention")
    assert fa.ENTRIES[want] == lib


def test_entry_refuses_other_dtypes_and_head_dims():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.entry(torch.float16, 64)
    for d in (48, 96, 512):
        with pytest.raises(ValueError, match="head dim"):
            fa.entry(torch.bfloat16, d)


def test_tma_strides_take_views_and_refuse_what_tma_cannot_read():
    base = torch.zeros(2, 256, 16, 64, dtype=torch.bfloat16)
    view = base.transpose(1, 2)  # attention_block's (B, S, H, D) -> (B, H, S, D) view
    assert wgmma.tma_strides(view, "v") == (256 * 16 * 64, 64, 16 * 64, 1)
    assert wgmma.tma_strides(view.contiguous(), "v") == (16 * 256 * 64, 256 * 64, 64, 1)
    wide = torch.zeros(1, 2, 128, 68, dtype=torch.bfloat16)[..., :64]  # rows of 136 bytes
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        wgmma.tma_strides(wide, "k")
    shifted = torch.zeros(1 * 2 * 128 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 2, 128, 64)
    assert shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        wgmma.tma_strides(shifted, "q")
    with pytest.raises(ValueError, match="unit last stride"):
        wgmma.tma_strides(base.permute(0, 2, 3, 1), "q")  # D strided by 16 heads


@pytest.mark.parametrize("d", wgmma.HEAD_DIMS)
def test_kernel_shared_memory_fits_one_block(d):
    assert wgmma.stages(d) == (3 if d == 64 else 2)
    assert wgmma.smem_bytes(d) <= fa.MAX_SMEM
    # two blocks share an SM (228 KB, 1 KB of it reserved per block) at D 128 too
    assert 2 * (wgmma.smem_bytes(d) + 1024) <= 233_472
    assert wgmma.smem_bytes(64) == 58_448 and wgmma.smem_bytes(128) == 83_000


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(1, 2, 2, 64, 64, 64, seed=3))
    fa.COUNTER.reset()
    got = fa.flash_attention(q, k, v)
    assert (fa.COUNTER.launches, fa.COUNTER.plain_calls, fa.COUNTER.entries) == (0, 1, {})
    assert torch.equal(got, fa.flash_attention_torch(q, k, v))


if __name__ == "__main__":  # the shares behind the rounded-once gate, printed
    for case in SHARE_CASES:
        *shape, causal, window, std = case
        q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(*shape, seed=7, std=std))
        kw = {"causal": causal, "window": window}
        shares = [rounded_once_share(o, q, k, v, **kw) for o in (
            fa.flash_attention_torch(q, k, v, **kw), _kernel_numerics(q, k, v, **kw),
            _kernel_numerics(q, k, v, terms=1, **kw))]
        print(f"{case}: rounded-once share, p in fp32 {shares[0]:.4%}, two bf16 terms "
              f"{shares[1]:.4%}, one bf16 term {shares[2]:.4%}")
