"""The bf16 tensor-core SSD scan's design, on the CPU.

``csrc/ssd_scan_wgmma.cu`` runs only on the card. Its numerics are emulated
in plain PyTorch (``ssd_scan_wgmma.emulate``: cum in order in fp32, the
chunk states, c b^T once per group, the states across chunks in fp32, and
every fp32 operand of a bf16 product as two bf16 terms ``hi = bf16(v)``,
``lo = bf16(v - hi)``) on inputs made with numpy from a seed, and held
against JAX's Pallas kernel in interpret mode and its sequential
``ssd_ref`` at the bf16 band of ``chip_smoke.py`` (1e-2 of max|y|), and
through its rounded-once gate: at most 1 % of y's elements may differ from
the fp64 SSD rounded once to bf16. One bf16 term per operand (the
``one_term`` control) must break that gate. The wrapper's choice of kernel,
TMA's operand rules, the workspace and the kernel's shared memory are pure
functions, tested here without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ssd_scan
from repro_torch.kernels import ssd_scan_wgmma as wgmma
from repro_torch.kernels.ref import ssd_ref, ssd_rounded_once_share

# (B, H, G, S, P, N, chunk): the Mamba-2 780M's P 64, N 128, chunk 128 at
# four heads, and G 2 at N 64 and chunk 64
CASES = [
    (1, 4, 1, 256, 64, 128, 128),
    (1, 4, 2, 256, 64, 64, 64),
]
BAND = 1e-2  # of max|y|: SSD_TOL["bfloat16"] of chip_smoke.py
ROUNDED_ONCE = 1e-2  # chip_smoke.py's gate
MAMBA2 = (torch.bfloat16, 64, 128, 128)  # mamba2_780m: P 64, N 128, chunk 128


def _inputs(bs, h, g, s, p, n, seed, dt_max=0.1):
    """The model's decay: la = -dt * A, A = 1..H, dt in [0, dt_max]."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(bs, h, s, p) * 0.5).astype(np.float32)
    dt = rng.rand(bs, h, s) * dt_max
    la = (-dt * np.arange(1, h + 1)[None, :, None]).astype(np.float32)
    b = (rng.randn(bs, g, s, n) * 0.3).astype(np.float32)
    c = (rng.randn(bs, g, s, n) * 0.3).astype(np.float32)
    return x, la, b, c


def _bf16(x, la, b, c):
    return (torch.from_numpy(x).bfloat16(), torch.from_numpy(la), torch.from_numpy(b).bfloat16(),
            torch.from_numpy(c).bfloat16())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("bs,h,g,s,p,n,chunk", CASES)
def test_emulation_matches_jax_kernel_and_ref(bs, h, g, s, p, n, chunk):
    arrs = _inputs(bs, h, g, s, p, n, seed=s + n)
    x, la, b, c = arrs
    want = np.asarray(jops.ssd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(la),
                               jnp.asarray(b, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16),
                               chunk=chunk, backend="interpret"), np.float32)
    seq = np.asarray(jref.ssd_ref(*(jnp.asarray(np.asarray(t.float()))
                                    for t in _bf16(*arrs))), np.float32)
    got = wgmma.emulate(*_bf16(*arrs), chunk=chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (bs, h, s, p)
    assert _rel(got.float().numpy(), want) <= BAND
    assert _rel(got.float().numpy(), seq) <= BAND


@pytest.mark.parametrize("bs,h,g,s,p,n,chunk", CASES)
def test_rounded_once_share_passes_two_terms_and_rejects_one(bs, h, g, s, p, n, chunk):
    x, la, b, c = _bf16(*_inputs(bs, h, g, s, p, n, seed=7))
    plain = ssd_rounded_once_share(ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk), x, la, b, c)
    two = ssd_rounded_once_share(wgmma.emulate(x, la, b, c, chunk=chunk), x, la, b, c)
    one = ssd_rounded_once_share(wgmma.emulate(x, la, b, c, chunk=chunk, terms=1), x, la, b, c)
    assert plain <= 1e-3  # every operand in fp32: a few elements in ten thousand
    assert two <= ROUNDED_ONCE
    assert one > ROUNDED_ONCE  # the one_term control fails it


def test_emulation_under_strong_decay_and_dt_to_one():
    """dt up to 1.0 at A up to 48: la to -48 per step. The decay above the
    diagonal overflows and is selected away; the result is finite and
    within the band of the sequential recurrence."""
    x, la, b, c = _bf16(*_inputs(1, 48, 2, 256, 64, 64, seed=4, dt_max=1.0))
    assert float(la.min()) < -40
    got = wgmma.emulate(x, la, b, c, chunk=128)
    assert bool(torch.isfinite(got).all())
    assert _rel(got.float().numpy(), ssd_ref(x, la, b, c).float().numpy()) <= BAND


def test_emulation_reads_values_not_layout():
    x, la, b, c = _bf16(*_inputs(1, 4, 1, 128, 64, 64, seed=5))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (x, la, b, c)]
    assert torch.equal(wgmma.emulate(*views, chunk=64), wgmma.emulate(x, la, b, c, chunk=64))


def test_emulation_refuses_other_term_counts():
    with pytest.raises(ValueError, match="terms"):
        wgmma.emulate(*_bf16(*_inputs(1, 1, 1, 64, 64, 64, seed=0)), chunk=64, terms=3)


# every shape of tests/test_torch_kernels_cuda.py::SSD_CASES and the Mamba-2 780M's
@pytest.mark.parametrize("bs,h,g,s,p,n,chunk", [
    (2, 4, 2, 256, 32, 32, 64),
    (1, 2, 1, 128, 64, 128, 128),
    (1, 4, 4, 192, 16, 32, 64),
    (1, 1, 1, 64, 8, 16, 32),
    (2, 48, 1, 2048, 64, 128, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_entry_follows_dtype_and_shape(bs, h, g, s, p, n, chunk, dtype):
    # fp32 at the shapes the bf16 kernel takes goes to the fp32 tensor-core
    # kernel (csrc/ssd_scan_tf32.cu); tests/test_torch_ssd_tf32.py holds it
    tensor_cores = p == 64 and n == 128 and chunk == 128
    libs = {torch.bfloat16: (wgmma.ENTRY, "ssd_scan_wgmma"),
            torch.float32: ("ssd_scan_f32_tf32", "ssd_scan_tf32")}
    want, lib = libs[dtype] if tensor_cores else (ssd_scan.FFMA[dtype], "ssd_scan")
    assert ssd_scan.entry(dtype, p, n, chunk) == want
    assert ssd_scan.ENTRIES[want] == lib


def test_takes_the_documented_shapes_only():
    assert wgmma.takes(*MAMBA2)
    assert ssd_scan.entry(*MAMBA2) == "ssd_scan_bf16_wgmma"
    for p, n, chunk in ((128, 64, 64), (192, 256, 128), (64, 192, 64)):
        assert wgmma.takes(torch.bfloat16, p, n, chunk)
    for p, n, chunk in ((32, 128, 128), (64, 96, 128), (64, 320, 128), (64, 128, 32),
                        (64, 128, 256), (0, 128, 128)):
        assert not wgmma.takes(torch.bfloat16, p, n, chunk)
    assert not wgmma.takes(torch.float32, 64, 128, 128)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_scan.entry(torch.float16, 64, 128, 128)


@pytest.mark.parametrize("n", [64, 128, 192, 256])
@pytest.mark.parametrize("chunk", wgmma.CHUNKS)
def test_kernel_shared_memory_fits_one_block(n, chunk):
    need = wgmma.smem_bytes(n, chunk)
    assert set(need) == {"states", "cb", "out"}
    assert max(need.values()) <= ssd_scan.MAX_SMEM
    if (n, chunk) == (128, 128):  # the Mamba-2 780M: two blocks of each pass share an SM
        assert need == {"states": 82_944, "cb": 66_560, "out": 82_944}
        assert 2 * (max(need.values()) + 1024) <= 233_472


def test_workspace_is_cum_cb_and_the_chunk_states():
    # Mamba-2 780M prefill, 2 x 2,048 tokens: 0.79 MB of cum, 2.1 MB of CB,
    # 50.3 MB of chunk states
    got = wgmma.workspace_bytes(2, 48, 1, 2048, 64, 128, 128)
    assert got == 4 * (2 * 48 * 2048 + 2 * 16 * 128 * 128 + 2 * 48 * 16 * 64 * 128)
    assert got == 53_215_232


def test_tma_strides_take_views_and_refuse_what_tma_cannot_read():
    base = torch.zeros(2, 256, 48, 64, dtype=torch.bfloat16)
    view = base.transpose(1, 2)  # ssm_block's (B, S, H, P) -> (B, H, S, P) view
    assert wgmma.tma_strides(view, "x") == (256 * 48 * 64, 64, 48 * 64, 1)
    assert wgmma.tma_strides(view.contiguous(), "x") == (48 * 256 * 64, 256 * 64, 64, 1)
    wide = torch.zeros(1, 2, 128, 68, dtype=torch.bfloat16)[..., :64]  # rows of 136 bytes
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        wgmma.tma_strides(wide, "b")
    shifted = torch.zeros(1 * 2 * 128 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 2, 128, 64)
    assert shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        wgmma.tma_strides(shifted, "c")
    with pytest.raises(ValueError, match="unit last stride"):
        wgmma.tma_strides(base.permute(0, 2, 3, 1), "x")  # P strided by 48 heads


def test_launch_refuses_cpu_tensors_and_unknown_entries():
    x, la, b, c = _bf16(*_inputs(1, 2, 1, 128, 64, 128, seed=3))
    ssd_scan.COUNTER.reset()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan.launch(wgmma.ENTRY, x, la, b, c)
    got = ssd_scan.ssd_scan(x, la, b, c)  # CPU tensors: the plain version
    assert (ssd_scan.COUNTER.launches, ssd_scan.COUNTER.plain_calls, ssd_scan.COUNTER.entries) \
        == (0, 1, {})
    assert torch.equal(got, ssd_scan.ssd_scan_torch(x, la, b, c))


if __name__ == "__main__":  # the shares behind the rounded-once gate, printed
    for case in CASES:
        *shape, chunk = case
        x, la, b, c = _bf16(*_inputs(*shape, seed=7))
        shares = [ssd_rounded_once_share(y, x, la, b, c) for y in (
            ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk),
            wgmma.emulate(x, la, b, c, chunk=chunk),
            wgmma.emulate(x, la, b, c, chunk=chunk, terms=1))]
        print(f"{case}: rounded-once share, plain {shares[0]:.4%}, two bf16 terms "
              f"{shares[1]:.4%}, one bf16 term {shares[2]:.4%}")
