"""The fp32 tensor-core SSD scan's design (3xTF32), on the CPU.

``csrc/ssd_scan_tf32.cu`` runs only on the card. Its arithmetic is emulated
in plain PyTorch (``ssd_scan_tf32.emulate``: cum in fp64 in order, the
decays from its fp64 differences; ``w_j x_j`` rounded before its split;
every product split into ``hi = tf32_rn(v)`` and ``lo = tf32_rn(v - hi)``,
each k8 slice's lo·hi + hi·lo + hi·hi summed from zero, the slices of a
stage of 32 K summed from zero, the stages added to the running sum in
order; the states across chunks in fp32) on inputs made with numpy from a
seed, and held against JAX's Pallas kernel in interpret mode and its
sequential ``ssd_ref`` at the fp32 band of ``chip_smoke.py`` (3e-5 of
max|y|), and through its RMS gate: the RMS error against the fp64
``ssd_ref`` at most 1.05 x the plain version's. The 1xTF32 product (hi·hi
alone, ``terms=1``) and the plain output rounded through bf16 must break
that gate, and decays from a cum summed in fp32 read above it. The
wrapper's choice of kernel, the operand rules, the workspace and the
kernel's shared memory are pure functions, tested here without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ssd_scan
from repro_torch.kernels import ssd_scan_tf32 as tf32
from repro_torch.kernels import ssd_scan_wgmma as wgmma
from repro_torch.kernels.ref import ssd_ref

# (B, H, G, S, P, N, chunk): the Mamba-2 780M's P 64, N 128, chunk 128 at
# four heads, G 2 at N 64 and chunk 64, and P 128, N 256
CASES = [
    (1, 4, 1, 256, 64, 128, 128),
    (1, 4, 2, 256, 64, 64, 64),
    (1, 2, 2, 256, 128, 256, 128),
]
BAND = 3e-5  # of max|y|: SSD_TOL["float32"] of chip_smoke.py
MM_RMS = 1.05  # chip_smoke.py's RMS gate
MAMBA2 = (torch.float32, 64, 128, 128)  # mamba2_780m: P 64, N 128, chunk 128


def _inputs(bs, h, g, s, p, n, seed, dt_max=0.1):
    """The model's decay: la = -dt * A, A = 1..H, dt in [0, dt_max]."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(bs, h, s, p) * 0.5).astype(np.float32)
    dt = rng.rand(bs, h, s) * dt_max
    la = (-dt * np.arange(1, h + 1)[None, :, None]).astype(np.float32)
    b = (rng.randn(bs, g, s, n) * 0.3).astype(np.float32)
    c = (rng.randn(bs, g, s, n) * 0.3).astype(np.float32)
    return x, la, b, c


def _torch(*arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _rms(x) -> float:
    return float(x.double().square().mean().sqrt())


@pytest.mark.parametrize("bs,h,g,s,p,n,chunk", CASES)
def test_emulation_matches_jax_kernel_and_ref(bs, h, g, s, p, n, chunk):
    arrs = _inputs(bs, h, g, s, p, n, seed=s + n)
    want = np.asarray(jops.ssd(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                               backend="interpret"))
    seq = np.asarray(jref.ssd_ref(*(jnp.asarray(a) for a in arrs)))
    got = tf32.emulate(*_torch(*arrs), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (bs, h, s, p)
    assert _rel(got.numpy(), want) <= BAND
    assert _rel(got.numpy(), seq) <= BAND


@pytest.mark.parametrize("bs,h,g,s,p,n,chunk", CASES)
def test_rms_gate_passes_three_terms_and_rejects_the_controls(bs, h, g, s, p, n, chunk):
    x, la, b, c = _torch(*_inputs(bs, h, g, s, p, n, seed=7))
    ref = ssd_ref(x, la, b, c, compute_dtype=torch.float64)
    plain = ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk)
    base = _rms(plain.double() - ref)
    three = _rms(tf32.emulate(x, la, b, c, chunk=chunk).double() - ref) / base
    one = _rms(tf32.emulate(x, la, b, c, chunk=chunk, terms=1).double() - ref) / base
    via_bf16 = _rms(plain.bfloat16().double() - ref) / base
    assert three <= MM_RMS  # about 0.3-0.7
    assert one > 100 * MM_RMS  # hi·hi alone keeps about 11 bits of each product
    assert via_bf16 > 100 * MM_RMS


def _dual(x, la, b, c, cum, cum64=None):
    """The chunked dual form (chunk 128) in fp32 with exact fp32 products, its
    decays from ``cum``'s differences, or from ``cum64``'s where given."""
    bs, h, s, p = x.shape
    g, n, q = b.shape[1], b.shape[3], 128
    nc = s // q
    xf, bf, cf = (x.reshape(bs, h, nc, q, p), b.reshape(bs, g, nc, q, n),
                  c.reshape(bs, g, nc, q, n))
    ref = cum if cum64 is None else cum64
    total = cum[..., -1:]
    w = torch.exp((ref[..., -1:] - ref).float())
    d = torch.exp((ref[..., :, None] - ref[..., None, :]).float())
    states = (w[..., None] * xf).transpose(-1, -2) @ bf
    state, ys = torch.zeros(bs, h, p, n), []
    for ci in range(nc):
        y = torch.exp(cum[:, :, ci])[..., None] * (cf[:, :, ci] @ state.transpose(-1, -2))
        sc = torch.where(torch.ones(q, q, dtype=torch.bool).tril(),
                         (cf[:, :, ci] @ bf[:, :, ci].transpose(-1, -2)) * d[:, :, ci], 0.0)
        ys.append(y + sc @ xf[:, :, ci])
        state = torch.exp(total[:, :, ci])[..., None] * state + states[:, :, ci]
    return torch.stack(ys, 2).reshape(bs, h, s, p)


def test_decays_from_fp64_differences_keep_the_scan_inside_the_gate():
    """exp(cum_i - cum_j) and exp(total - cum_j) carry the absolute error of
    the cums they subtract. With exact fp32 products, cum summed in fp32 in
    order reads above the gate, cum summed in fp64 and rounded once reads
    the plain version's (torch's CPU cumsum sums fp32 in fp64); the
    kernel's decays, from the fp64 differences, read well below either."""
    x, la, b, c = _torch(*_inputs(1, 4, 1, 256, 64, 128, seed=7))
    ref = ssd_ref(x, la, b, c, compute_dtype=torch.float64)
    base = _rms(ssd_scan.ssd_scan_torch(x, la, b, c).double() - ref)
    laf = la.reshape(1, 4, 2, 128)
    run, cum32 = torch.zeros_like(laf[..., 0]), torch.empty_like(laf)
    for i in range(128):
        run = run + laf[..., i]
        cum32[..., i] = run
    cum64 = torch.cumsum(laf.double(), dim=-1)
    assert _rms(_dual(x, la, b, c, cum32).double() - ref) / base > MM_RMS
    assert 0.95 <= _rms(_dual(x, la, b, c, cum64.float()).double() - ref) / base <= MM_RMS
    assert _rms(_dual(x, la, b, c, cum64.float(), cum64).double() - ref) / base < 0.75
    assert _rms(tf32.emulate(x, la, b, c).double() - ref) / base < 0.75


def test_emulation_under_strong_decay_and_dt_to_one():
    """dt up to 1.0 at A up to 48: la to -48 per step. The decay above the
    diagonal overflows and is selected away; the result is finite and
    within the band of the sequential recurrence."""
    x, la, b, c = _torch(*_inputs(1, 48, 2, 256, 64, 64, seed=4, dt_max=1.0))
    assert float(la.min()) < -40
    got = tf32.emulate(x, la, b, c, chunk=128)
    seq = ssd_ref(x, la, b, c).numpy()
    assert bool(torch.isfinite(got).all())
    assert _rel(got.numpy(), seq) <= BAND
    # the plain dual form's rounded cums cancel here; the fp64 decays do not
    plain = ssd_scan.ssd_scan_torch(x, la, b, c, chunk=128).numpy()
    assert _rel(got.numpy(), seq) < _rel(plain, seq) / 10


def test_emulation_reads_values_not_layout_and_refuses_other_term_counts():
    x, la, b, c = _torch(*_inputs(1, 4, 1, 128, 64, 64, seed=5))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (x, la, b, c)]
    assert torch.equal(tf32.emulate(*views, chunk=64), tf32.emulate(x, la, b, c, chunk=64))
    with pytest.raises(ValueError, match="terms"):
        tf32.emulate(x, la, b, c, chunk=64, terms=2)


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
    tensor_cores = p == 64 and n == 128 and chunk == 128
    want = ({torch.float32: tf32.ENTRY, torch.bfloat16: wgmma.ENTRY}[dtype] if tensor_cores
            else ssd_scan.FFMA[dtype])
    assert ssd_scan.entry(dtype, p, n, chunk) == want
    assert tf32.takes(dtype, p, n, chunk) == (tensor_cores and dtype == torch.float32)


def test_takes_the_documented_shapes_only():
    assert tf32.takes(*MAMBA2)
    assert ssd_scan.entry(*MAMBA2) == "ssd_scan_f32_tf32"
    assert ssd_scan.ENTRIES[tf32.ENTRY] == tf32.LIB == "ssd_scan_tf32"
    for p, n, chunk in ((128, 64, 64), (192, 256, 128), (64, 192, 64)):
        assert tf32.takes(torch.float32, p, n, chunk)
    for p, n, chunk in ((32, 128, 128), (64, 96, 128), (64, 320, 128), (64, 128, 32),
                        (64, 128, 256), (0, 128, 128)):
        assert not tf32.takes(torch.float32, p, n, chunk)
        assert ssd_scan.entry(torch.float32, p, n, chunk) == "ssd_scan_f32"
    assert not tf32.takes(torch.bfloat16, 64, 128, 128)


@pytest.mark.parametrize("chunk", tf32.CHUNKS)
def test_kernel_shared_memory_fits_one_block(chunk):
    need = tf32.smem_bytes(chunk)
    assert set(need) == {"states", "cb", "out"}
    assert max(need.values()) <= ssd_scan.MAX_SMEM
    if chunk == 128:  # the Mamba-2 780M
        assert need == {"states": 99_328, "cb": 132_096, "out": 99_328}


def test_workspace_is_cum_cb_and_the_chunk_states():
    # Mamba-2 780M prefill, 2 x 2,048 tokens: the bf16 kernel's layout
    got = tf32.workspace_bytes(2, 48, 1, 2048, 64, 128, 128)
    assert got == wgmma.workspace_bytes(2, 48, 1, 2048, 64, 128, 128) == 53_215_232


def test_operand_rules_take_views_and_refuse_what_the_kernel_cannot_read():
    base = torch.zeros(2, 256, 48, 64)
    view = base.transpose(1, 2)  # ssm_block's (B, S, H, P) -> (B, H, S, P) view
    assert tf32.operand_strides(view, "x") == (256 * 48 * 64, 64, 48 * 64, 1)
    assert tf32.operand_strides(view.contiguous(), "x") == (48 * 256 * 64, 256 * 64, 64, 1)
    wide = torch.zeros(1, 2, 128, 66)[..., :64]  # rows of 264 bytes
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tf32.operand_strides(wide, "b")
    shifted = torch.zeros(1 * 2 * 128 * 64 + 1)[1:].view(1, 2, 128, 64)
    assert shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        tf32.operand_strides(shifted, "c")
    with pytest.raises(ValueError, match="unit last stride"):
        tf32.operand_strides(base.permute(0, 2, 3, 1), "x")  # P strided by 48 heads


def test_launch_refuses_cpu_tensors_and_cpu_runs_the_plain_version():
    x, la, b, c = _torch(*_inputs(1, 2, 1, 128, 64, 128, seed=3))
    ssd_scan.COUNTER.reset()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan.launch(tf32.ENTRY, x, la, b, c)
    got = ssd_scan.ssd_scan(x, la, b, c)  # CPU tensors: the plain version
    assert (ssd_scan.COUNTER.launches, ssd_scan.COUNTER.plain_calls, ssd_scan.COUNTER.entries) \
        == (0, 1, {})
    assert torch.equal(got, ssd_scan.ssd_scan_torch(x, la, b, c))


if __name__ == "__main__":  # the RMS ratios behind the gate, printed
    x, la, b, c = _torch(*_inputs(1, 4, 1, 256, 64, 128, seed=7))
    ref = ssd_ref(x, la, b, c, compute_dtype=torch.float64)
    base = _rms(ssd_scan.ssd_scan_torch(x, la, b, c).double() - ref)
    laf = la.reshape(1, 4, 2, 128)
    run, cum32 = torch.zeros_like(laf[..., 0]), torch.empty_like(laf)
    for i in range(128):
        run = run + laf[..., i]
        cum32[..., i] = run
    cum64 = torch.cumsum(laf.double(), dim=-1)
    print("decays, exact fp32 products, RMS vs fp64 over the plain version's: fp32 cums "
          f"{_rms(_dual(x, la, b, c, cum32).double() - ref) / base:.4f}, fp64 cums rounded "
          f"{_rms(_dual(x, la, b, c, cum64.float()).double() - ref) / base:.4f}, fp64 "
          f"differences {_rms(_dual(x, la, b, c, cum64.float(), cum64).double() - ref) / base:.4f};"
          f" the kernel's emulation {_rms(tf32.emulate(x, la, b, c).double() - ref) / base:.4f}")
    for case in CASES:
        *shape, chunk = case
        x, la, b, c = _torch(*_inputs(*shape, seed=7))
        ref = ssd_ref(x, la, b, c, compute_dtype=torch.float64)
        base = _rms(ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk).double() - ref)
        print(f"{case}: RMS vs fp64 over the plain version's, 3xTF32 "
              f"{_rms(tf32.emulate(x, la, b, c, chunk=chunk).double() - ref) / base:.4f}, "
              f"1xTF32 "
              f"{_rms(tf32.emulate(x, la, b, c, chunk=chunk, terms=1).double() - ref) / base:.1f}")
