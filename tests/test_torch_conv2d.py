"""The port's NTX direct convolution (``conv2d_ntx``) against JAX's, on the CPU.

The cases of ``tests/kernels/test_conv2d.py`` go through JAX's
``conv2d_ntx(interpret=True, tile_h=4)`` (the Pallas kernel in interpret
mode) and the port's ``conv2d_ntx(tile_h=4)``, which on CPU tensors runs the
kernel's plain version, at that file's atol / rtol 1e-4; and through both
packages' ``conv2d_ref``. Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.conv2d import conv2d_ntx as jax_conv2d_ntx
from repro_torch.kernels import conv2d
from repro_torch.kernels.conv2d import conv2d_ntx
from repro_torch.kernels.ref import conv2d_ref

CASES = [
    # (n, h, w, cin, kh, kw, cout, stride)
    (1, 12, 12, 3, 3, 3, 8, 1),
    (2, 16, 10, 4, 3, 3, 8, 2),
    (1, 9, 9, 3, 1, 1, 16, 1),
    (1, 14, 14, 3, 5, 5, 4, 2),
    (2, 11, 13, 2, 3, 2, 4, 3),
    (1, 8, 8, 8, 7, 7, 4, 1),
]


def _operands(n, h, w, cin, kh, kw, cout, stride):
    rng = np.random.RandomState(h * 10 + kh + stride)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(kh, kw, cin, cout) * 0.2).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("n,h,w,cin,kh,kw,cout,stride", CASES)
def test_conv_matches_jax_interpret(n, h, w, cin, kh, kw, cout, stride):
    x, wt = _operands(n, h, w, cin, kh, kw, cout, stride)
    want = np.asarray(jax_conv2d_ntx(jnp.asarray(x), jnp.asarray(wt), stride=stride, tile_h=4,
                                     interpret=True))
    got = conv2d_ntx(torch.from_numpy(x), torch.from_numpy(wt), stride=stride, tile_h=4)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    jwant = np.asarray(jref.conv2d_ref(jnp.asarray(x), jnp.asarray(wt), stride=stride))
    np.testing.assert_allclose(got.numpy(), jwant, atol=1e-4, rtol=1e-4)
    ref = conv2d_ref(torch.from_numpy(x), torch.from_numpy(wt), stride=stride)
    np.testing.assert_allclose(ref.numpy(), jwant, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tile_h", [1, 3, 8, 64])
def test_row_tiles_cover_every_output_row(tile_h):
    """th = min(tile_h, OH): short last tiles and a tile taller than OH."""
    x, wt = _operands(2, 16, 10, 4, 3, 3, 8, 2)
    want = np.asarray(jax_conv2d_ntx(jnp.asarray(x), jnp.asarray(wt), stride=2, tile_h=tile_h,
                                     interpret=True))
    got = conv2d_ntx(torch.from_numpy(x), torch.from_numpy(wt), stride=2, tile_h=tile_h)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_conv_bf16_matches_jax_interpret():
    x, wt = _operands(2, 16, 10, 4, 3, 3, 8, 2)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16)
    want = np.asarray(jax_conv2d_ntx(jx, jw, stride=2, tile_h=4, interpret=True), np.float32)
    tx = torch.from_numpy(np.array(jx, np.float32)).bfloat16()
    tw = torch.from_numpy(np.array(jw, np.float32)).bfloat16()
    got = conv2d_ntx(tx, tw, stride=2, tile_h=4)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(got.float().numpy() - want).max()) <= 1e-2 * float(np.abs(want).max())


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 3)])
def test_conv2d_ref_pads_as_jax(stride, padding):
    x, wt = _operands(2, 16, 10, 4, 3, 3, 8, 2)
    want = np.asarray(jref.conv2d_ref(jnp.asarray(x), jnp.asarray(wt), stride=stride,
                                      padding=padding))
    got = conv2d_ref(torch.from_numpy(x), torch.from_numpy(wt), stride=stride, padding=padding)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_strided_input_and_refusals():
    rng = np.random.RandomState(9)
    x_nchw = torch.from_numpy(rng.randn(2, 3, 15, 15).astype(np.float32))
    wt = torch.from_numpy((rng.randn(7, 7, 3, 4) * 0.2).astype(np.float32))
    x = x_nchw.permute(0, 2, 3, 1)  # NHWC view of NCHW data
    torch.testing.assert_close(conv2d_ntx(x, wt, stride=2), conv2d_ntx(x.contiguous(), wt,
                                                                        stride=2))
    conv2d.COUNTER.reset()
    conv2d_ntx(x, wt)
    assert (conv2d.COUNTER.launches, conv2d.COUNTER.plain_calls) == (0, 1)
    with pytest.raises(ValueError, match="bad shapes"):
        conv2d_ntx(x, wt[:, :, :2])
    with pytest.raises(ValueError, match="must be positive"):
        conv2d_ntx(x, wt, stride=0)
    with pytest.raises(ValueError, match="must be positive"):
        conv2d_ntx(x, wt, tile_h=0)
    with pytest.raises(ValueError, match="smaller than the kernel"):
        conv2d_ntx(x[:, :5], wt)
    with pytest.raises(ValueError, match="on the CPU or all on one CUDA"):
        conv2d_ntx(x, wt.to("meta"))
