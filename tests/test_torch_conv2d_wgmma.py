"""The bf16 tensor-core conv2d_ntx kernel's design, on the CPU.

``csrc/conv2d_ntx_wgmma.cu`` runs only on the card. What surrounds it is
tested here without one: ``conv2d.entry``'s choice of kernel by dtype and
channel counts, the operand rules the wrapper checks before a launch
(``conv2d_ntx_wgmma.x_strides``), the kernel's shared memory, the plain
version on CPU tensors, and the numerics behind ``chip_smoke.py``'s
rounded-once gate (``kernels/ref.py::conv_rounded_once_share``): the plain
version and an emulation of the kernel's order (fp32 sums over 16-channel
slices of each tap, the ``wgmma`` k16 steps) differ from the fp64 conv
rounded once to bf16 in at most 1 % of y's elements; the control, which
rounds its sum to bf16 after every stage of 64 channels of a tap, does not.
The bf16 plain version is also held against JAX's Pallas kernel in
interpret mode. Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import conv2d_ntx as jax_conv2d_ntx
from repro_torch.kernels import conv2d, conv2d_ntx_stem, conv2d_ntx_tf32
from repro_torch.kernels import conv2d_ntx_wgmma as wgmma
from repro_torch.kernels.ref import conv_rounded_once_share

MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
# (n, h, w, cin, k, cout, stride): GoogLeNet L1's and L2's channels at 3 x 3,
# L3's at 1 x 1, and a stride-2 case
SHARE_CASES = [
    (2, 12, 12, 64, 3, 192, 1),
    (2, 10, 10, 256, 3, 64, 1),
    (2, 8, 8, 512, 1, 192, 1),
    (1, 13, 13, 128, 3, 64, 2),
]


def _operands(n, h, w, cin, k, cout, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32)).bfloat16()
    wt = torch.from_numpy((rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)).bfloat16()
    return x, wt


def _staged(x, w, stride, chunk, *, round_bf16=False):
    """The (u, v, ci) loop in slices of ``chunk`` channels of one tap with an
    fp32 accumulator, rounded to bf16 after every slice if ``round_bf16``;
    y rounded once to bf16."""
    kh, kw, cin, cout = w.shape
    n, h, wid, _ = x.shape
    oh, ow = (h - kh) // stride + 1, (wid - kw) // stride + 1
    xf, wf = x.float(), w.float()
    acc = torch.zeros((n, oh, ow, cout))
    for u in range(kh):
        for v in range(kw):
            xs = xf[:, u:u + (oh - 1) * stride + 1:stride, v:v + (ow - 1) * stride + 1:stride]
            for c0 in range(0, cin, chunk):
                acc = acc + xs[..., c0:c0 + chunk] @ wf[u, v, c0:c0 + chunk]
                if round_bf16:
                    acc = acc.bfloat16().float()
    return acc.bfloat16()


# Cin 3 (L0, 7 x 7 at stride 2) and Cin 96 at 1 x 1 in bf16 go to the stem
# kernel (csrc/conv2d_ntx_stem.cu): kh*kw*Cin <= 256, Cout a multiple of 64
@pytest.mark.parametrize("dtype,cin,cout,want", [
    (torch.float32, 64, 192, conv2d_ntx_tf32.ENTRY),
    (torch.float32, 3, 64, conv2d_ntx_stem.ENTRY),
    (torch.bfloat16, 64, 192, wgmma.ENTRY),
    (torch.bfloat16, 256, 64, wgmma.ENTRY),
    (torch.bfloat16, 512, 192, wgmma.ENTRY),
    (torch.bfloat16, 128, 128, wgmma.ENTRY),
    (torch.bfloat16, 3, 64, conv2d_ntx_stem.ENTRY),
    (torch.bfloat16, 96, 64, conv2d_ntx_stem.ENTRY),
    (torch.bfloat16, 64, 100, conv2d.FFMA),
], ids=["f32-L1", "f32-L0", "bf16-L1", "bf16-L2", "bf16-L3", "bf16-128", "bf16-L0",
        "bf16-cin96", "bf16-cout100"])
def test_entry_follows_dtype_and_channels(dtype, cin, cout, want):
    # L0's and L1's taps (fp32 1 x 1 at Cin 64 is a short sum: FFMA)
    k, stride = (7, 2) if cin == 3 else (3, 1) if (cin, cout) == (64, 192) else (1, 1)
    assert conv2d.entry(dtype, cin, cout, k, k, stride) == want
    lib = {wgmma.ENTRY: wgmma.LIB, conv2d_ntx_tf32.ENTRY: conv2d_ntx_tf32.LIB,
           conv2d_ntx_stem.ENTRY: conv2d_ntx_stem.LIB}.get(want, "conv2d_ntx")
    assert conv2d.ENTRIES[want] == lib


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_entry_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv2d.entry(dtype, 64, 64)


def test_operand_rules_take_views_and_refuse_what_the_kernel_cannot_read():
    w = torch.zeros(3, 3, 64, 192, dtype=torch.bfloat16)
    x = torch.zeros(2, 18, 18, 64, dtype=torch.bfloat16)
    assert wgmma.x_strides(x, w) == (18 * 18 * 64, 18 * 64, 64)
    inner = x[:, 1:-1, 1:-1]  # a padded plane's interior: strides kept, base moved 1,216 bytes
    assert wgmma.x_strides(inner, w) == (18 * 18 * 64, 18 * 64, 64)
    wide = torch.zeros(2, 16, 16, 68, dtype=torch.bfloat16)[..., :64]  # pixels of 136 bytes
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        wgmma.x_strides(wide, w)
    nchw = torch.zeros(2, 64, 16, 16, dtype=torch.bfloat16).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="unit channel stride"):
        wgmma.x_strides(nchw, w)
    shifted = torch.zeros(2 * 16 * 16 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 16, 64)
    assert shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        wgmma.x_strides(shifted, w)
    w_shifted = torch.zeros(3 * 3 * 64 * 192 + 1, dtype=torch.bfloat16)[1:].view(3, 3, 64, 192)
    with pytest.raises(ValueError, match="w needs a 16-byte-aligned base"):
        wgmma.x_strides(x, w_shifted)


@pytest.mark.parametrize("cout", [64, 128, 192, 256, 384])
def test_kernel_shared_memory_fits_one_block(cout):
    assert wgmma.block_n(cout) == (192 if cout % 192 == 0 else 64)
    assert wgmma.smem_bytes(cout) <= MAX_SMEM
    if wgmma.block_n(cout) == 64:  # two blocks share an SM (228 KB, 1 KB reserved per block)
        assert 2 * (wgmma.smem_bytes(cout) + 1024) <= 233_472
    assert wgmma.smem_bytes(192) == 164_928 and wgmma.smem_bytes(64) == 99_392


def test_cpu_tensors_take_the_plain_version():
    x, wt = _operands(2, 10, 10, 64, 3, 192, seed=3)
    conv2d.COUNTER.reset()
    got = conv2d.conv2d_ntx(x, wt)
    assert (conv2d.COUNTER.launches, conv2d.COUNTER.plain_calls, conv2d.COUNTER.entries) == (
        0, 1, {})
    assert torch.equal(got, conv2d.conv2d_ntx_torch(x, wt))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        conv2d.launch(wgmma.ENTRY, x, wt)
    assert conv2d.COUNTER.launches == 0


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride", SHARE_CASES)
def test_rounded_once_share_passes_fp32_sums_and_rejects_bf16_stages(n, h, w, cin, k, cout,
                                                                     stride):
    x, wt = _operands(n, h, w, cin, k, cout, seed=h + cin + k)
    plain = conv_rounded_once_share(conv2d.conv2d_ntx_torch(x, wt, stride=stride), x, wt, stride)
    k16 = conv_rounded_once_share(_staged(x, wt, stride, 16), x, wt, stride)
    control = conv_rounded_once_share(_staged(x, wt, stride, 64, round_bf16=True), x, wt, stride)
    assert plain <= 1e-3  # fp32 sums, rounded once: a few elements in ten thousand
    assert k16 <= 1e-2  # the gate of chip_smoke.py (ROUNDED_ONCE)
    assert control > 1e-2  # sums rounded to bf16 per stage: the control fails it


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride", [c for c in SHARE_CASES if c[4] == 3
                                                      and c[6] == 1])
def test_per_tap_control_is_rejected_at_three_by_three(n, h, w, cin, k, cout, stride):
    """The sum rounded to bf16 after every tap (nine roundings) breaks the gate."""
    x, wt = _operands(n, h, w, cin, k, cout, seed=h + cin + k)
    per_tap = _staged(x, wt, stride, cin, round_bf16=True)
    assert conv_rounded_once_share(per_tap, x, wt, stride) > 1e-2


def test_a_per_tap_control_is_blind_at_one_tap():
    """At 1 x 1 a sum rounded per tap is rounded once: the control must round per stage."""
    x, wt = _operands(2, 8, 8, 512, 1, 192, seed=5)
    per_tap = _staged(x, wt, 1, 512, round_bf16=True)
    assert torch.equal(per_tap, _staged(x, wt, 1, 512))
    assert conv_rounded_once_share(per_tap, x, wt, 1) <= 1e-3


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride", [(2, 10, 10, 64, 3, 192, 1),
                                                      (1, 11, 11, 128, 3, 64, 2)])
def test_bf16_plain_matches_jax_interpret(n, h, w, cin, k, cout, stride):
    x, wt = _operands(n, h, w, cin, k, cout, seed=7)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jw = jnp.asarray(wt.float().numpy(), jnp.bfloat16)
    want = np.asarray(jax_conv2d_ntx(jx, jw, stride=stride, tile_h=4, interpret=True),
                      np.float32)
    got = conv2d.conv2d_ntx(x, wt, stride=stride, tile_h=4)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert float(np.abs(got.float().numpy() - want).max()) <= 1e-2 * float(np.abs(want).max())


if __name__ == "__main__":  # the shares behind the rounded-once gate, printed
    for case in SHARE_CASES:
        n, h, w, cin, k, cout, stride = case
        x, wt = _operands(n, h, w, cin, k, cout, seed=h + cin + k)
        shares = [conv_rounded_once_share(y, x, wt, stride) for y in (
            conv2d.conv2d_ntx_torch(x, wt, stride=stride), _staged(x, wt, stride, 16),
            _staged(x, wt, stride, 64, round_bf16=True))]
        print(f"{case}: rounded-once share, plain {shares[0]:.4%}, fp32 sums in k16 slices "
              f"{shares[1]:.4%}, bf16 per stage (control) {shares[2]:.4%}")
