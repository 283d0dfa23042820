"""The fp32 tensor-core conv2d_ntx kernel's design (3xTF32), on the CPU.

``csrc/conv2d_ntx_tf32.cu`` runs only on the card. Its arithmetic is
emulated here in plain PyTorch (``conv2d_ntx_tf32.emulate``: x and w split
into ``hi = tf32_rn(v)`` and ``lo = tf32_rn(v - hi)``; per tap and stage of
32 input channels, each k8 slice's lo·hi + hi·lo + hi·hi summed from zero,
the stage's slices summed from zero, the stage added to the pixel's sum) on
inputs made with numpy from a seed, and held against JAX's Pallas kernel in
interpret mode at the fp32 band of ``chip_smoke.py`` (CONV_F32: atol and
rtol 1e-4) and through its RMS gate: the RMS error against the fp64 conv
at most 1.05 x the plain version's. The 1xTF32 product (hi·hi alone,
``terms=1``) and the plain output rounded through bf16 must break that gate.
The wrapper's choice of kernel, the operand rules, the tiles, the shared
memory and the workspace are pure functions, tested here without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import conv2d_ntx as jax_conv2d_ntx
from repro_torch.kernels import conv2d
from repro_torch.kernels import conv2d_ntx_tf32 as tf32
from repro_torch.kernels.gemm_wgmma import split_tf32
from repro_torch.kernels.ref import conv2d_ref

CONV_F32 = {"atol": 1e-4, "rtol": 1e-4}  # chip_smoke.py's fp32 band
MM_RMS = 1.05  # chip_smoke.py's RMS gate
MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
# (n, h, w, cin, k, cout, stride): GoogLeNet L1's, L2's and L3's channels at
# small planes, Cin 32 (one stage a tap), a stride-2 case and a ragged Cout tile
CASES = [
    (2, 12, 12, 64, 3, 192, 1),
    (2, 10, 10, 256, 1, 64, 1),
    (2, 8, 8, 512, 1, 192, 1),
    (1, 13, 13, 128, 3, 64, 2),
    (1, 9, 11, 32, 3, 128, 1),
]


def _operands(n, h, w, cin, k, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    return x, wt


def _rms(x) -> float:
    return float(x.double().square().mean().sqrt())


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride", CASES)
def test_emulation_matches_jax_kernel_f32(n, h, w, cin, k, cout, stride):
    x, wt = _operands(n, h, w, cin, k, cout, seed=h + cin + k)
    want = np.asarray(jax_conv2d_ntx(jnp.asarray(x), jnp.asarray(wt), stride=stride, tile_h=4,
                                     interpret=True))
    got = tf32.emulate(torch.from_numpy(x), torch.from_numpy(wt), stride=stride)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **CONV_F32)


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride", CASES)
def test_rms_gate_passes_three_terms_and_rejects_the_controls(n, h, w, cin, k, cout, stride):
    x, wt = (torch.from_numpy(a) for a in _operands(n, h, w, cin, k, cout, seed=3 + cin))
    ref = conv2d_ref(x.double(), wt.double(), stride=stride)
    plain = conv2d.conv2d_ntx_torch(x, wt, stride=stride)
    base = _rms(plain.double() - ref)
    three = _rms(tf32.emulate(x, wt, stride=stride).double() - ref) / base
    one = _rms(tf32.emulate(x, wt, stride=stride, terms=1).double() - ref) / base
    via_bf16 = _rms(plain.bfloat16().double() - ref) / base
    assert three <= MM_RMS  # the gate of chip_smoke.py
    assert one > 100 * MM_RMS  # hi·hi alone keeps about 11 bits of each product
    assert via_bf16 > 100 * MM_RMS


def test_one_term_also_breaks_the_band():
    x, wt = (torch.from_numpy(a) for a in _operands(2, 10, 10, 64, 3, 192, seed=1))
    want = conv2d.conv2d_ntx_torch(x, wt)
    one = tf32.emulate(x, wt, terms=1)
    band = ((one - want).abs() / (CONV_F32["atol"] + CONV_F32["rtol"] * want.abs())).max()
    assert float(band) > 1


def test_stage_sums_keep_the_conv_inside_the_gate_at_three_by_three():
    """Slices added one by one into the pixel's sum read more than the
    stage's own sum at 3 x 3 and Cin 64 (GoogLeNet L1's channels): the
    kernel sums each stage of 32 channels from zero first."""
    x, wt = (torch.from_numpy(a) for a in _operands(2, 12, 12, 64, 3, 192, seed=0))
    ref = conv2d_ref(x.double(), wt.double())
    base = _rms(conv2d.conv2d_ntx_torch(x, wt).double() - ref)
    (xh, xl), (wh, wl) = split_tf32(x), split_tf32(wt)
    flat = torch.zeros(2, 10, 10, 192)
    for u in range(3):
        for v in range(3):
            ah, al = xh[:, u:u + 10, v:v + 10], xl[:, u:u + 10, v:v + 10]
            for c0 in range(0, 64, 8):
                cs = slice(c0, c0 + 8)
                flat = flat + ((al[..., cs] @ wh[u, v, cs] + ah[..., cs] @ wl[u, v, cs])
                               + ah[..., cs] @ wh[u, v, cs])
    staged = _rms(tf32.emulate(x, wt).double() - ref) / base
    assert staged < _rms(flat.double() - ref) / base
    assert staged <= MM_RMS


def test_emulation_does_not_depend_on_tile_h_and_refuses_other_term_counts():
    x, wt = (torch.from_numpy(a) for a in _operands(1, 9, 9, 32, 3, 64, seed=2))
    y = tf32.emulate(x, wt)
    assert y.shape == (1, 7, 7, 64)
    with pytest.raises(ValueError, match="terms must be 1 or 3"):
        tf32.emulate(x, wt, terms=2)


@pytest.mark.parametrize("cin,cout,want", [
    (64, 192, tf32.ENTRY), (256, 64, tf32.ENTRY), (512, 192, tf32.ENTRY), (32, 64, tf32.ENTRY),
    (96, 128, tf32.ENTRY), (3, 64, conv2d.FFMA), (48, 64, conv2d.FFMA), (64, 100, conv2d.FFMA),
    (64, 32, conv2d.FFMA),
], ids=["L1", "L2", "L3", "cin32", "cin96", "L0", "cin48", "cout100", "cout32"])
def test_entry_sends_fp32_by_channels(cin, cout, want):
    assert conv2d.entry(torch.float32, cin, cout) == want
    assert tf32.takes(torch.float32, cin, cout) == (want == tf32.ENTRY)
    assert not tf32.takes(torch.bfloat16, cin, cout)
    assert conv2d.ENTRIES[want] == (tf32.LIB if want == tf32.ENTRY else "conv2d_ntx")


@pytest.mark.parametrize("cout", [64, 128, 192, 256, 384])
def test_tiles_and_shared_memory_fit_one_block(cout):
    assert tf32.block_n(cout) == (96 if cout % 96 == 0 else 64)
    assert cout % tf32.block_n(cout) == 0
    assert tf32.smem_bytes(cout) <= MAX_SMEM
    assert tf32.smem_bytes(192) == 230_464 and tf32.smem_bytes(64) == 197_696


def test_workspace_holds_w_split_k_major():
    assert tf32.workspace_numel(3, 3, 64, 192) == 2 * 576 * 192
    assert tf32.workspace_numel(1, 1, 512, 192) == 2 * 512 * 192


def test_operand_rules_take_views_and_refuse_what_the_kernel_cannot_read():
    x = torch.zeros(2, 18, 18, 64)
    assert tf32.x_strides(x) == (18 * 18 * 64, 18 * 64, 64)
    inner = x[:, 1:-1, 1:-1]  # a padded plane's interior: strides kept, base moved
    assert tf32.x_strides(inner) == (18 * 18 * 64, 18 * 64, 64)
    wide = torch.zeros(2, 16, 16, 66)[..., :64]  # pixels of 264 bytes
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tf32.x_strides(wide)
    nchw = torch.zeros(2, 64, 16, 16).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="unit channel stride"):
        tf32.x_strides(nchw)
    shifted = torch.zeros(2 * 16 * 16 * 64 + 1)[1:].view(2, 16, 16, 64)
    assert shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        tf32.x_strides(shifted)


def test_cpu_tensors_take_the_plain_version():
    x, wt = (torch.from_numpy(a) for a in _operands(2, 10, 10, 64, 3, 192, seed=3))
    conv2d.COUNTER.reset()
    got = conv2d.conv2d_ntx(x, wt)
    assert (conv2d.COUNTER.launches, conv2d.COUNTER.plain_calls, conv2d.COUNTER.entries) == (
        0, 1, {})
    assert torch.equal(got, conv2d.conv2d_ntx_torch(x, wt))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        conv2d.launch(tf32.ENTRY, x, wt)
    assert conv2d.COUNTER.launches == 0


if __name__ == "__main__":  # the RMS ratios behind the gate, printed
    for case in CASES:
        n, h, w, cin, k, cout, stride = case
        x, wt = (torch.from_numpy(a) for a in _operands(*case[:6], seed=3 + cin))
        ref = conv2d_ref(x.double(), wt.double(), stride=stride)
        plain = conv2d.conv2d_ntx_torch(x, wt, stride=stride)
        base = _rms(plain.double() - ref)
        print(f"{case}: RMS vs fp64 over the plain version's, 3xTF32 "
              f"{_rms(tf32.emulate(x, wt, stride=stride).double() - ref) / base:.4f}, 1xTF32 "
              f"{_rms(tf32.emulate(x, wt, stride=stride, terms=1).double() - ref) / base:.1f}, "
              f"plain via bf16 {_rms(plain.bfloat16().double() - ref) / base:.1f}")
