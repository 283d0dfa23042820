"""The tensor-core GEMM of K-tile partials (B2 and B5) and its design, on the CPU.

``csrc/ntx_gemm_wgmma.cu`` runs only on the card. Its numerics are emulated
here in plain PyTorch (``gemm_wgmma.emulate``: fp32 operands split into
``hi = tf32_rn(x)`` and ``lo = tf32_rn(x - hi)``, each k8 slice's lo·hi, hi·lo
and hi·hi summed from zero, bf16 operands in k16 slices, each slice added to
its K tile's sum, tiles joined in order) on operands made with numpy from a
seed, and held against JAX's Pallas kernels in interpret mode at the bands of
``test_torch_ntx_matmul.py`` and ``test_torch_streaming.py``, and through
``chip_smoke.py``'s RMS gate: the RMS error against the fp64 product at most
1.05x the plain version's. The 1xTF32 control (hi·hi alone) must break the
band and the RMS gate. The split over K, the tiles, shared memory, workspace
and the wrappers' refusals are pure functions of the shapes, tested without
a card.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import streaming as jax_streaming
from repro_torch.kernels import build
from repro_torch.kernels import gemm_wgmma as gemm
from repro_torch.kernels import ntx_matmul as mm
from repro_torch.kernels import ops, streaming
from repro_torch.kernels.ref import matmul_ref64

MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
MM_RMS = 1.05  # chip_smoke.py's RMS gate
# the shapes of test_torch_ntx_matmul.py (M, N, K)
MM_SHAPES = [(128, 128, 128), (128, 128, 512), (256, 128, 384), (64, 64, 64), (100, 70, 333),
             (8, 200, 40)]
# the shapes of test_torch_streaming.py (M, N, K)
STREAM_SHAPES = [(128, 128, 128), (128, 128, 512), (64, 64, 256), (100, 70, 333), (8, 200, 40)]
# GoogLeNet L0-L3's im2col widths (K, N) at a reduced M: the RMS gate's cases
RMS_SHAPES = [(1024, 64, 147), (512, 192, 576), (1024, 64, 256), (512, 192, 512)]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the 11 streaming_matmul calls of one unfused paper-CNN step at batch 64, img 32 (M, N, K)
STEP_CALLS = [(16384, 16, 75), (4096, 32, 144), (64, 10, 512), (512, 10, 64), (64, 512, 10),
              (144, 32, 4096), (5184, 16, 128), (4608, 16, 64), (4608, 16, 64), (4096, 16, 32),
              (75, 16, 16384)]


def _operands(m, n, k, jdt, tdt, seed):
    rng = np.random.RandomState(seed)
    ja = jnp.asarray(rng.randn(m, k), jdt)
    jb = jnp.asarray(rng.randn(k, n), jdt)
    ta = torch.from_numpy(np.array(ja, np.float32)).to(tdt)
    tb = torch.from_numpy(np.array(jb, np.float32)).to(tdt)
    return ja, jb, ta, tb


def _rms(x) -> float:
    return float(x.double().square().mean().sqrt())


def _band(got, want, k, dtype) -> float:
    """Error in units of the ntx_matmul band (<= 1 passes)."""
    atol = (2e-5 if dtype == torch.float32 else 2e-2) * k ** 0.5
    return float(((got - want).abs() / (atol + 1e-2 * want.abs())).max())


def _rms_ratio(got, a, b, block_k, compensated) -> float:
    """RMS error vs the fp64 product over the plain version's."""
    ref = matmul_ref64(a, b)
    want = mm.ntx_matmul_torch(a, b, block_k=block_k, compensated=compensated)
    return _rms(got.double() - ref) / _rms(want.double() - ref)


@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "comp"])
@pytest.mark.parametrize("m,n,k", MM_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_emulation_matches_jax_ntx_matmul(m, n, k, dt, compensated):
    ja, jb, ta, tb = _operands(m, n, k, *DTYPES[dt], seed=m + n + k)
    want = np.asarray(jops.matmul(ja, jb, backend="interpret", compensated=compensated))
    got = gemm.emulate(ta, tb, block_k=ops.matmul_block_k(k), compensated=compensated)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    tol = 2e-5 * np.sqrt(k) if dt == "f32" else 2e-2 * np.sqrt(k)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=1e-2)


@pytest.mark.parametrize("m,n,k", STREAM_SHAPES)
def test_emulation_matches_jax_streaming_matmul(m, n, k):
    rng = np.random.RandomState(m + n + k)
    a = (rng.randn(m, k) / np.sqrt(k)).astype(np.float32)  # unit-scale outputs
    b = rng.randn(k, n).astype(np.float32)
    want = jax_streaming.streaming_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    got = gemm.emulate(torch.from_numpy(a), torch.from_numpy(b), block_k=streaming._block(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "comp"])
@pytest.mark.parametrize("m,n,k", RMS_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_emulation_passes_the_rms_gate(m, n, k, dt, compensated):
    _, _, a, b = _operands(m, n, k, *DTYPES[dt], seed=k)
    bk = ops.matmul_block_k(k)
    got = gemm.emulate(a, b, block_k=bk, compensated=compensated)
    assert _rms_ratio(got, a, b, bk, compensated) <= MM_RMS
    assert _band(got, mm.ntx_matmul_torch(a, b, block_k=bk, compensated=compensated), k,
                 a.dtype) <= 1


@pytest.mark.parametrize("m,n,k", RMS_SHAPES)
def test_one_tf32_term_is_rejected_by_both_gates(m, n, k):
    """The 1xTF32 control: hi·hi alone keeps 11 bits of each operand."""
    _, _, a, b = _operands(m, n, k, jnp.float32, torch.float32, seed=k)
    bk = ops.matmul_block_k(k)
    ctl = gemm.emulate(a, b, block_k=bk, terms=1)
    assert _rms_ratio(ctl, a, b, bk, False) > 100 * MM_RMS
    assert _band(ctl, mm.ntx_matmul_torch(a, b, block_k=bk), k, a.dtype) > 10


def test_tf32_rn_rounds_to_nearest_even_at_ten_bits():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([one + ulp / 2, one + 3 * ulp / 2, one + ulp / 2 + 2.0 ** -20,
                      one + ulp / 2 - 2.0 ** -20, -(one + 3 * ulp / 2), 0.0, -0.0,
                      float("inf"), -float("inf"), torch.finfo(torch.float32).max],
                     dtype=torch.float32)
    want = torch.tensor([one, one + 2 * ulp, one + ulp, one, -(one + 2 * ulp), 0.0, -0.0,
                         float("inf"), -float("inf"), float("inf")], dtype=torch.float32)
    got = gemm.tf32_rn(x)
    assert torch.equal(got, want) and torch.equal(got.signbit(), want.signbit())
    assert torch.isnan(gemm.tf32_rn(torch.tensor([float("nan")]))).all()


def test_split_tf32_keeps_22_bits():
    x = torch.from_numpy(np.random.RandomState(0).randn(10_000).astype(np.float32) * 1e3)
    hi, lo = gemm.split_tf32(x)
    for t in (hi, lo):  # exact TF32 values: the low 13 bits are zero
        assert int((t.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((x.double() - hi.double()).abs() / x.double().abs()).max()) <= 2.0 ** -11
    err = (x.double() - hi.double() - lo.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -21
    hi, lo = gemm.split_tf32(torch.tensor([float("inf"), torch.finfo(torch.float32).max]))
    assert torch.equal(lo, torch.zeros(2))  # no inf - inf in the lo term


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("split", [2, 3, 7, 100])
def test_split_joins_the_same_partials_in_the_same_order(dt, split):
    """Partials formed part by part and joined in a second pass give the
    bits of the in-register join, compensated and plain."""
    _, _, a, b = _operands(40, 24, 1000, *DTYPES[dt], seed=split)
    for comp in (False, True):
        one = gemm.emulate(a, b, block_k=64, compensated=comp)
        assert torch.equal(gemm.emulate(a, b, block_k=64, compensated=comp, split=split), one)


@pytest.mark.parametrize("n_k_tiles,split", [(0, 1), (1, 8), (5, 1), (5, 2), (32, 32), (128, 128),
                                             (128, 60), (7, 3), (1728, 33)])
def test_k_ranges_cover_every_tile_once_in_order(n_k_tiles, split):
    ranges = gemm.k_ranges(n_k_tiles, split)
    tiles = [kt for lo, hi in ranges for kt in range(lo, hi)]
    assert tiles == list(range(n_k_tiles))
    assert all(hi > lo for lo, hi in ranges) or n_k_tiles == 0
    assert len(ranges) <= max(split, 1)
    assert len({hi - lo for lo, hi in ranges[:-1]}) <= 1  # equal parts but the last


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_ragged_tiles_are_padded_with_zeros(dt):
    """K = 333 in tiles of 100: the last stage of each tile and the ragged
    last tile are masked; inserting the zeros explicitly (tiles of 104 with
    4 zero columns each) gives the same bits."""
    _, _, a, b = _operands(48, 40, 333, *DTYPES[dt], seed=11)
    got = gemm.emulate(a, b, block_k=100, compensated=True)
    pad_a = torch.zeros(48, 4 * 104, dtype=a.dtype)
    pad_b = torch.zeros(4 * 104, 40, dtype=b.dtype)
    for t in range(4):
        w = min(100, 333 - 100 * t)
        pad_a[:, 104 * t:104 * t + w] = a[:, 100 * t:100 * t + w]
        pad_b[104 * t:104 * t + w] = b[100 * t:100 * t + w]
    assert torch.equal(gemm.emulate(pad_a, pad_b, block_k=104, compensated=True), got)


@pytest.mark.parametrize("block_k", [1, 16, 100, 1728, 4096])
def test_emulation_takes_any_block_k(block_k):
    _, _, a, b = _operands(13, 7, 1728, jnp.float32, torch.float32, seed=block_k)
    got = gemm.emulate(a, b, block_k=block_k, compensated=True)
    want = mm.ntx_matmul_torch(a, b, block_k=block_k, compensated=True)
    assert _band(got, want, 1728, torch.float32) <= 1


def test_compensated_emulation_is_exact_on_integers():
    """The compensation gate's operands: integers below 256, K = 1,728 in
    tiles of 128; every tile sums exactly and the totals cross 2**24."""
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randint(0, 256, (64, 1728)).astype(np.float32))
    b = torch.from_numpy(rng.randint(0, 256, (1728, 32)).astype(np.float32))
    exact = matmul_ref64(a, b).float()
    assert bool((exact > 2.0 ** 24).all())
    assert torch.equal(gemm.emulate(a, b, block_k=128, compensated=True), exact)
    assert not torch.equal(gemm.emulate(a, b, block_k=128), exact)  # the control


def test_shared_memory_fits_one_block():
    assert gemm.smem_bytes(torch.float32) == 214_016
    assert gemm.smem_bytes(torch.bfloat16) == 164_864
    assert all(gemm.smem_bytes(dt) + 64 <= MAX_SMEM for dt in (torch.float32, torch.bfloat16))
    for dt in (torch.float32, torch.bfloat16):  # a stage (128 bytes of K) holds four slices
        assert gemm.ROW == 4 * gemm.SLICE[dt] * torch.empty(0, dtype=dt).element_size()


@pytest.mark.parametrize("m,n,k,split", list(zip(
    *zip(*STEP_CALLS), (1, 2, 4, 1, 1, 32, 1, 1, 1, 1, 128))))
def test_plan_split_of_the_training_step(m, n, k, split):
    """Only the products with few tiles of C and several K tiles split:
    c1 dW (75 x 16, 128 K tiles) goes to 128 CTAs, c2 dW to 64."""
    assert gemm.plan_split(m, n, k, streaming._block(k)) == split


def test_a_training_step_launches_four_joins():
    """The split's second pass runs only where a call has more than one part:
    4 of the step's 11 calls, so chip_smoke.py's main path of 5 steps counts
    55 GEMM launches and 20 join launches."""
    joins = [gemm.workspace_numel(m, n, k, streaming._block(k),
                                  gemm.plan_split(m, n, k, streaming._block(k))) > 0
             for m, n, k in STEP_CALLS]
    assert sum(joins) == 4 and [i for i, j in enumerate(joins) if j] == [1, 2, 5, 10]


def test_fused_gate_probe_builds_its_variants_from_the_sources():
    """tools/chip_probe_fused_gate.py patches the checkout's sources into its
    variants; each patch must still find its text (the probe exits if not)."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "tools" / "chip_probe_fused_gate.py"
    spec = importlib.util.spec_from_file_location("chip_probe_fused_gate", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = probe.variants(build.CSRC)
    assert set(src) == {("fused_region", "tiles"), ("fused_region", "chain"),
                        ("ntx_gemm_wgmma", "slice"), ("ntx_gemm_wgmma", "apart")}
    assert src["fused_region", "tiles"] == (build.CSRC / "fused_region.cu").read_text()
    assert src["ntx_gemm_wgmma", "slice"] == (build.CSRC / "ntx_gemm_wgmma.cu").read_text()
    assert "slice_apart(prod, sl, sb, at, bt, kk);" in src["ntx_gemm_wgmma", "apart"]
    assert "acc = fmaf(a[k], b[k * N + n], acc);" in src["fused_region", "chain"]


def test_plan_split_rules():
    assert gemm.tiles(100_352, 192) == 2352 and gemm.plan_split(100_352, 192, 576, 128) == 1
    assert gemm.plan_split(1024, 1024, 1024, 128) == 1  # 128 tiles fill the card
    assert gemm.plan_split(9000, 64, 1024, 128) == 1  # 71 tiles: more than half the card
    assert gemm.plan_split(4096, 64, 1024, 128) == 5  # 32 tiles -> ceil(132 / 32)
    assert gemm.plan_split(75, 16, 16384, 128, sms=16) == 16
    assert gemm.plan_split(0, 16, 16384, 128) == 1 and gemm.plan_split(75, 16, 0, 128) == 1
    # the workspace cap, 256 MiB: 4,096 K tiles of a 128 x 64 output take 128 MiB, of a
    # 128 x 192 output 384 MiB
    assert gemm.plan_split(128, 64, 4096, 1) > 1 and gemm.plan_split(128, 192, 4096, 1) == 1
    assert gemm.workspace_numel(75, 16, 16384, 128, 128) == 128 * 75 * 16
    assert gemm.workspace_numel(75, 16, 16384, 128, 1) == 0
    assert gemm.workspace_numel(75, 16, 100, 128, 8) == 0  # one K tile: no second pass


def test_launch_refuses_what_the_kernel_does_not_take():
    meta = dict(device="meta")
    a, b = torch.empty(64, 32, **meta), torch.empty(32, 16, **meta)
    with pytest.raises(TypeError, match="one type"):
        gemm.launch(a, b.bfloat16(), block_k=16)
    with pytest.raises(TypeError, match="one type"):
        gemm.launch(a.half(), b.half(), block_k=16)
    with pytest.raises(TypeError, match="out_dtype"):
        gemm.launch(a, b, block_k=16, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="block_k"):
        gemm.launch(a, b, block_k=0, split=1)
    with pytest.raises(ValueError, match="split 0"):
        gemm.launch(a, b, block_k=16, split=0)
    big_a, big_b = torch.empty(4096, 8192, **meta), torch.empty(8192, 4096, **meta)
    with pytest.raises(ValueError, match="bytes of workspace"):
        gemm.launch(big_a, big_b, block_k=128, split=2)


def test_wrappers_route_cpu_tensors_to_the_plain_versions_and_name_entries():
    a, b = torch.ones(4, 3), torch.ones(3, 2)
    mm.COUNTER.reset()
    streaming.COUNTER.reset()
    assert torch.equal(mm.tiled_matmul(a, b, block_k=2), torch.full((4, 2), 3.0))
    assert torch.equal(streaming.streaming_matmul(a, b), torch.full((4, 2), 3.0))
    assert (mm.COUNTER.launches, mm.COUNTER.plain_calls, mm.COUNTER.entries) == (0, 1, {})
    assert (streaming.COUNTER.launches, streaming.COUNTER.plain_calls) == (0, 1)
    assert set(mm.ENTRIES) == {gemm.ENTRY, mm.FFMA} and mm.ENTRIES[gemm.ENTRY] == gemm.LIB
    assert set(streaming.ENTRIES) == {gemm.ENTRY, streaming.FFMA}
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        mm.launch(gemm.ENTRY, a, b, block_k=2)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        streaming.launch(streaming.FFMA, a, b)
    meta_a, meta_b = a.to("meta"), b.to("meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        mm.launch(gemm.ENTRY, meta_a, meta_b, block_k=2)


if __name__ == "__main__":  # the RMS ratios behind the gate, printed
    for dt in sorted(DTYPES):
        for m, n, k in RMS_SHAPES:
            _, _, a, b = _operands(m, n, k, *DTYPES[dt], seed=k)
            bk = ops.matmul_block_k(k)
            line = f"{dt} {m}x{k}x{n}: RMS vs fp64 over the plain version's, emulation "
            line += " / ".join(
                f"{_rms_ratio(gemm.emulate(a, b, block_k=bk, compensated=c), a, b, bk, c):.4f}"
                for c in (False, True))
            if dt == "f32":
                ctl = gemm.emulate(a, b, block_k=bk, terms=1)
                line += (f"; 1xTF32 control {_rms_ratio(ctl, a, b, bk, False):.1f}x, band "
                         f"{_band(ctl, mm.ntx_matmul_torch(a, b, block_k=bk), k, a.dtype):.2f}")
            print(line + " (plain / compensated)")
