"""The tensor-core stem conv2d_ntx kernel's design (bf16 and 3xTF32), on the CPU.

``csrc/conv2d_ntx_stem.cu`` runs only on the card. Its arithmetic is
emulated here in plain PyTorch (``conv2d_ntx_stem.emulate``: K = (u, v, ci)
flattened and padded with zeros to whole slices; fp32 split into ``hi =
tf32_rn(v)`` and ``lo = tf32_rn(v - hi)``, each k8 slice's lo·hi + hi·lo +
hi·hi summed from zero, the slices of a stage of 32 K summed from zero, the
stage added to the pixel's sum; bf16 k16 slices summed in fp32 and rounded
once) on inputs made with numpy from a seed, and held against JAX's Pallas
kernel in interpret mode and the fp64 conv: fp32 at the band of
``chip_smoke.py`` (CONV_F32: atol and rtol 1e-4) and through its RMS gate
(RMS error against the fp64 conv at most 1.05 x the plain version's; the
1xTF32 product and the output rounded through bf16 must break it), bf16 at
the 1e-2 band and through the rounded-once gate (at most 1 % of y off the
fp64 conv rounded once; the sum rounded to bf16 after every tap must break
it). The wrapper's choice of kernel, the shapes the kernel takes and its
shared memory are pure functions, tested here without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import conv2d_ntx as jax_conv2d_ntx
from repro_torch.kernels import conv2d
from repro_torch.kernels import conv2d_ntx_stem as stem
from repro_torch.kernels import conv2d_ntx_tf32 as tf32
from repro_torch.kernels import conv2d_ntx_wgmma as wgmma
from repro_torch.kernels.gemm_wgmma import split_tf32
from repro_torch.kernels.ref import conv2d_ref, conv_rounded_once_share

CONV_F32 = {"atol": 1e-4, "rtol": 1e-4}  # chip_smoke.py's fp32 band
CONV_BF16 = 1e-2  # chip_smoke.py's bf16 band, of max|y|
MM_RMS = 1.05  # chip_smoke.py's RMS gate
ROUNDED_ONCE = 1e-2  # chip_smoke.py's rounded-once gate
MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
L0 = (7, 7, 3, 64, 2)  # GoogLeNet's stem: kh, kw, Cin, Cout, stride
# (n, h, w, cin, k, cout, stride): L0's 7 x 7 x 3 -> 64 at stride 2 on small
# planes (ragged pixel tiles), Cout 128, and 3 x 3 stems of Cin 3 and 5
CASES = [
    (2, 40, 40, 3, 7, 64, 2),
    (1, 29, 23, 3, 7, 128, 2),
    (2, 14, 19, 3, 3, 64, 1),
    (1, 17, 15, 5, 3, 64, 2),
]
# the RMS gate holds at L0's long sums (K = 147); at K 27 / 45 3xTF32 reads
# above the plain version (about 1.4x): a short sum does not hide the
# product error of 3xTF32 (lo.lo dropped), as the tf32 attention showed, so
# fp32 below conv2d.F32_TF32_MIN_K goes to the FFMA entry
L0_CASES = [(2, 40, 40, 3, 7, 64, 2), (1, 45, 45, 3, 7, 128, 2)]
# the sweep of K behind conv2d.F32_TF32_MIN_K: (kh, kw, Cin, emulation) on
# 2 x 24 x 24 planes (12 x 12 at Cin >= 32), Cout 64, stride 1. The Cin-3
# stem at growing taps, and the 3xTF32 wide conv at 1 x 1 and 3 x 3
K_SWEEP = [(3, 3, 3, stem), (3, 5, 3, stem), (3, 7, 3, stem), (5, 5, 3, stem),
           (5, 7, 3, stem), (7, 7, 3, stem), (7, 9, 3, stem), (9, 9, 3, stem),
           (1, 1, 32, tf32), (1, 1, 64, tf32), (1, 1, 96, tf32), (1, 1, 128, tf32),
           (3, 3, 32, tf32)]
SWEEP_SEEDS = (0, 1)


def _operands(n, h, w, cin, k, cout, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32)).to(dtype)
    wt = torch.from_numpy((rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)).to(dtype)
    return x, wt


def _rms(x) -> float:
    return float(x.double().square().mean().sqrt())


def sweep_ratio(kh, kw, cin, mod, seed, terms=3) -> float:
    """RMS error against the fp64 conv of ``mod.emulate`` over the plain version's."""
    hw = 12 if cin >= 32 else 24
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(2, hw, hw, cin).astype(np.float32))
    wt = torch.from_numpy((rng.randn(kh, kw, cin, 64) * 0.2).astype(np.float32))
    ref = conv2d_ref(x.double(), wt.double())
    base = _rms(conv2d.conv2d_ntx_torch(x, wt).double() - ref)
    return _rms(mod.emulate(x, wt, terms=terms).double() - ref) / base


def ffma_order(x, w, per_tap: bool):
    """fp32 FMAs over K = (u, v, ci) in order, each rounded once: one chain over
    all of K, or each tap's Cin products from zero, then added tap by tap (the
    FFMA kernel's order since it sums one K tile per tap)."""
    kh, kw, cin, cout = w.shape
    a = stem._im2col(x.float(), kh, kw, 1).double()
    b = w.reshape(-1, cout).double()
    acc = torch.zeros(*a.shape[:-1], cout)
    tap = torch.zeros_like(acc)
    for r in range(a.shape[-1]):
        if per_tap:
            tap = (tap.double() + a[..., r:r + 1] * b[r]).float()
            if (r + 1) % cin == 0:
                acc, tap = acc + tap, torch.zeros_like(acc)
        else:
            acc = (acc.double() + a[..., r:r + 1] * b[r]).float()
    return acc


def _per_tap_bf16(x, w, stride):
    """The control of the rounded-once gate: the (u, v) loop with the fp32
    sum rounded to bf16 after every tap (every stage of Cin < 64 channels)."""
    kh, kw, cin, cout = w.shape
    n, h, wid, _ = x.shape
    oh, ow = (h - kh) // stride + 1, (wid - kw) // stride + 1
    xf, wf = x.float(), w.float()
    acc = torch.zeros(n, oh, ow, cout)
    for u in range(kh):
        for v in range(kw):
            xs = xf[:, u:u + (oh - 1) * stride + 1:stride, v:v + (ow - 1) * stride + 1:stride]
            acc = (acc + xs @ wf[u, v]).bfloat16().float()
    return acc.bfloat16()


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride", CASES)
def test_emulation_matches_jax_kernel_f32(n, h, w, cin, k, cout, stride):
    x, wt = _operands(n, h, w, cin, k, cout, seed=h + cin + k)
    want = np.asarray(jax_conv2d_ntx(jnp.asarray(x.numpy()), jnp.asarray(wt.numpy()),
                                     stride=stride, tile_h=4, interpret=True))
    got = stem.emulate(x, wt, stride=stride)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **CONV_F32)
    ref = conv2d_ref(x.double(), wt.double(), stride=stride)
    torch.testing.assert_close(got.double(), ref, **CONV_F32)


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride", CASES)
def test_emulation_matches_jax_kernel_bf16(n, h, w, cin, k, cout, stride):
    x, wt = _operands(n, h, w, cin, k, cout, seed=h + cin + k + 1, dtype=torch.bfloat16)
    want = np.asarray(jax_conv2d_ntx(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(wt.float().numpy(), jnp.bfloat16),
                                     stride=stride, tile_h=4, interpret=True), np.float32)
    got = stem.emulate(x, wt, stride=stride)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    scale = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= CONV_BF16 * scale


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride", L0_CASES)
def test_rms_gate_passes_three_terms_and_rejects_the_controls(n, h, w, cin, k, cout, stride):
    x, wt = _operands(n, h, w, cin, k, cout, seed=3 + h)
    ref = conv2d_ref(x.double(), wt.double(), stride=stride)
    plain = conv2d.conv2d_ntx_torch(x, wt, stride=stride)
    base = _rms(plain.double() - ref)
    three = _rms(stem.emulate(x, wt, stride=stride).double() - ref) / base
    one = _rms(stem.emulate(x, wt, stride=stride, terms=1).double() - ref) / base
    via_bf16 = _rms(plain.bfloat16().double() - ref) / base
    assert three <= MM_RMS  # about 0.82 at L0
    assert one > 100 * MM_RMS  # hi·hi alone keeps about 11 bits of each product
    assert via_bf16 > 100 * MM_RMS


def test_stage_sums_beat_slices_straight_into_the_pixel_sum_at_l0():
    """The kernel sums each stage of four k8 slices from zero first: at L0 that
    reads below slices added one by one into the pixel's sum."""
    x, wt = _operands(2, 40, 40, 3, 7, 64, seed=0)
    ref = conv2d_ref(x.double(), wt.double(), stride=2)
    base = _rms(conv2d.conv2d_ntx_torch(x, wt, stride=2).double() - ref)
    a = stem._im2col(x, 7, 7, 2)
    a = torch.nn.functional.pad(a, (0, 152 - 147))
    b = torch.nn.functional.pad(wt.reshape(147, 64), (0, 0, 0, 152 - 147))
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    flat = torch.zeros(*a.shape[:-1], 64)
    for k0 in range(0, 152, 8):
        cs = slice(k0, k0 + 8)
        flat = flat + ((al[..., cs] @ bh[cs] + ah[..., cs] @ bl[cs]) + ah[..., cs] @ bh[cs])
    staged = _rms(stem.emulate(x, wt, stride=2).double() - ref) / base
    assert staged < _rms(flat.double() - ref) / base <= MM_RMS


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride", CASES)
def test_rounded_once_gate_passes_bf16_and_rejects_per_tap_rounding(n, h, w, cin, k, cout,
                                                                     stride):
    x, wt = _operands(n, h, w, cin, k, cout, seed=5 + w, dtype=torch.bfloat16)
    got = conv_rounded_once_share(stem.emulate(x, wt, stride=stride), x, wt, stride)
    plain = conv_rounded_once_share(conv2d.conv2d_ntx_torch(x, wt, stride=stride), x, wt, stride)
    control = conv_rounded_once_share(_per_tap_bf16(x, wt, stride), x, wt, stride)
    assert got <= ROUNDED_ONCE and plain <= ROUNDED_ONCE
    assert control > ROUNDED_ONCE


def test_emulation_reads_values_not_layout_and_refuses_other_term_counts():
    rng = np.random.RandomState(4)
    nchw = torch.from_numpy(rng.randn(1, 3, 30, 30).astype(np.float32))
    x = nchw.permute(0, 2, 3, 1)  # chip_smoke.py's fp32 L0: NCHW data viewed as NHWC
    wt = torch.from_numpy((rng.randn(7, 7, 3, 64) * 0.2).astype(np.float32))
    assert not x.is_contiguous()
    assert torch.equal(stem.emulate(x, wt, stride=2), stem.emulate(x.contiguous(), wt, stride=2))
    with pytest.raises(ValueError, match="terms must be 1 or 3"):
        stem.emulate(x, wt, stride=2, terms=2)


def test_f32_tf32_min_k_is_the_least_k_of_the_sweep_inside_the_rms_gate():
    """F32_TF32_MIN_K is the least K of the sweep from which on every point, of
    both fp32 tensor-core entries, reads at most MM_RMS x the plain version's
    RMS error against fp64 (on two seeds); the stem's last K below it reads above."""
    worst: dict[int, float] = {}
    for kh, kw, cin, mod in K_SWEEP:
        k = kh * kw * cin
        r = max(sweep_ratio(kh, kw, cin, mod, seed) for seed in SWEEP_SEEDS)
        worst[k] = max(worst.get(k, 0.0), r)
    least = min(k for k in worst if all(r <= MM_RMS for k2, r in worst.items() if k2 >= k))
    assert least == conv2d.F32_TF32_MIN_K == 96
    assert worst[27] > 1.3 and worst[45] > 1.15  # 3 x 3 and 3 x 5 stems
    assert worst[75] > MM_RMS >= worst[96]


@pytest.mark.parametrize("kh,kw,cin,cout,stride", [
    (3, 3, 3, 64, 1), (3, 3, 5, 64, 2), (3, 5, 3, 64, 1), (5, 5, 3, 64, 1), (1, 1, 32, 64, 1),
    (1, 1, 64, 192, 1),
], ids=["K27", "K45-cin5", "K45-cin3", "K75", "1x1-cin32", "1x1-cin64"])
def test_short_fp32_sums_go_to_the_ffma_entry(kh, kw, cin, cout, stride):
    """fp32 with K below F32_TF32_MIN_K leaves both tensor-core entries (their
    shape rules still take it); bf16 keeps its routes."""
    assert kh * kw * cin < conv2d.F32_TF32_MIN_K
    assert stem.takes(torch.float32, kh, kw, cin, cout, stride) or tf32.takes(
        torch.float32, cin, cout)
    assert conv2d.entry(torch.float32, cin, cout, kh, kw, stride) == conv2d.FFMA
    bf16 = wgmma.ENTRY if wgmma.takes(torch.bfloat16, cin, cout) else stem.ENTRY
    assert conv2d.entry(torch.bfloat16, cin, cout, kh, kw, stride) == bf16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_googlenet_layers_keep_their_tensor_core_entries(dtype):
    """The main path's convs (GoogLeNet L0-L3) keep their routes in both dtypes."""
    wide = wgmma.ENTRY if dtype == torch.bfloat16 else tf32.ENTRY
    for (kh, cin, cout, stride), want in (((7, 3, 64, 2), stem.ENTRY), ((3, 64, 192, 1), wide),
                                          ((1, 256, 64, 1), wide), ((1, 512, 192, 1), wide)):
        assert kh * kh * cin >= conv2d.F32_TF32_MIN_K
        assert conv2d.entry(dtype, cin, cout, kh, kh, stride) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_entry_sends_the_stem_to_its_kernel(dtype):
    kh, kw, cin, cout, stride = L0
    assert conv2d.entry(dtype, cin, cout, kh, kw, stride) == stem.ENTRY
    assert stem.takes(dtype, kh, kw, cin, cout, stride)
    assert conv2d.ENTRIES[stem.ENTRY] == stem.LIB == "conv2d_ntx_stem"
    # the wide kernels keep their channels; what none takes stays on FFMA
    wide = wgmma.ENTRY if dtype == torch.bfloat16 else tf32.ENTRY
    assert conv2d.entry(dtype, 64, 192, 3, 3, 1) == wide
    assert not stem.takes(dtype, 3, 3, 64, 192)
    assert conv2d.entry(dtype, 3, 70, 7, 7, 2) == conv2d.FFMA  # Cout not a multiple of 64
    assert conv2d.entry(dtype, 48, 64, 3, 3, 1) == conv2d.FFMA  # K 432 > 256
    assert conv2d.entry(dtype, 3, 64, 7, 7, 20) == conv2d.FFMA  # the slab outgrows a block


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kh,kw,cin,cout,stride,want", [
    (7, 7, 3, 64, 2, True), (3, 3, 3, 64, 1, True), (1, 1, 3, 128, 1, True),
    (5, 5, 10, 64, 1, True), (16, 16, 1, 64, 1, True), (7, 7, 6, 64, 2, False),
    (3, 3, 3, 96, 1, False), (3, 3, 3, 0, 1, False), (7, 7, 3, 64, 20, False),
], ids=["L0", "3x3", "1x1", "K250", "K256", "K294", "cout96", "cout0", "stride20"])
def test_takes_the_documented_shapes_only(dtype, kh, kw, cin, cout, stride, want):
    assert stem.takes(dtype, kh, kw, cin, cout, stride) == want
    assert not stem.takes(torch.float16, kh, kw, cin, cout, stride)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_shared_memory_fits_one_block(dtype):
    need = stem.smem_bytes(dtype, 7, 7, 3, 2)
    assert need == {torch.float32: 102_200, torch.bfloat16: 30_902}[dtype]
    assert 2 * (need + 1024) <= 233_472  # two blocks share an SM at L0
    assert stem.smem_bytes(dtype, 16, 16, 1, 1) <= MAX_SMEM
    assert stem.smem_bytes(dtype, 7, 7, 3, 20) > MAX_SMEM


def test_cpu_tensors_take_the_plain_version():
    x, wt = _operands(2, 20, 20, 3, 7, 64, seed=3)
    conv2d.COUNTER.reset()
    got = conv2d.conv2d_ntx(x, wt, stride=2)
    assert (conv2d.COUNTER.launches, conv2d.COUNTER.plain_calls, conv2d.COUNTER.entries) == (
        0, 1, {})
    assert torch.equal(got, conv2d.conv2d_ntx_torch(x, wt, stride=2))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        conv2d.launch(stem.ENTRY, x, wt, stride=2)
    assert conv2d.COUNTER.launches == 0


if __name__ == "__main__":  # the gates' readings, printed
    for kh, kw, cin, mod in K_SWEEP:
        print(f"sweep K {kh * kw * cin} ({kh} x {kw} x {cin}, {mod.__name__.split('.')[-1]}): "
              f"RMS vs fp64 over the plain version's "
              f"{[round(sweep_ratio(kh, kw, cin, mod, s), 4) for s in SWEEP_SEEDS]}")
    for kh, kw, cin in ((3, 3, 3), (3, 3, 5), (7, 7, 3), (3, 3, 16)):  # the FFMA conv's order
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(2, 20, 20, cin).astype(np.float32))
        wt = torch.from_numpy((rng.randn(kh, kw, cin, 64) * 0.2).astype(np.float32))
        ref = conv2d_ref(x.double(), wt.double())
        base = _rms(conv2d.conv2d_ntx_torch(x, wt).double() - ref)
        print(f"FFMA order at {kh} x {kw} x {cin}: RMS vs fp64 over the plain version's, one "
              f"chain over K {_rms(ffma_order(x, wt, False).double() - ref) / base:.4f}, per tap "
              f"{_rms(ffma_order(x, wt, True).double() - ref) / base:.4f}")
    for kh, kw, cin in ((3, 3, 8), (3, 3, 16), (3, 7, 8)):  # stems past the threshold, few taps
        print(f"remainder {kh} x {kw} x {cin} (K {kh * kw * cin}): "
              f"{[round(sweep_ratio(kh, kw, cin, stem, s), 4) for s in SWEEP_SEEDS]}")
    for case in CASES:
        n, h, w, cin, k, cout, stride = case
        x, wt = _operands(*case[:6], seed=3 + h)
        ref = conv2d_ref(x.double(), wt.double(), stride=stride)
        base = _rms(conv2d.conv2d_ntx_torch(x, wt, stride=stride).double() - ref)
        xb, wb = x.bfloat16(), wt.bfloat16()
        print(f"{case}: RMS vs fp64 over the plain version's, 3xTF32 "
              f"{_rms(stem.emulate(x, wt, stride=stride).double() - ref) / base:.4f}, 1xTF32 "
              f"{_rms(stem.emulate(x, wt, stride=stride, terms=1).double() - ref) / base:.1f}; "
              f"bf16 rounded-once share "
              f"{conv_rounded_once_share(stem.emulate(xb, wb, stride=stride), xb, wb, stride):.4%}"
              f", per-tap control "
              f"{conv_rounded_once_share(_per_tap_bf16(xb, wb, stride), xb, wb, stride):.4%}")
