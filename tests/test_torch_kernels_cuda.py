"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one; they import nothing of
JAX so that they run on a machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_jax
from repro_torch.kernels import conv2d, flash_attention, fused, ntx_matmul, ops, ssd_scan, streaming
from repro_torch.kernels import conv2d_ntx_stem as conv_stem
from repro_torch.kernels import conv2d_ntx_tf32 as conv_tf32
from repro_torch.kernels import conv2d_ntx_wgmma as conv_wgmma
from repro_torch.kernels import flash_attention_tf32 as attn_tf32
from repro_torch.kernels import flash_attention_wgmma as wgmma
from repro_torch.kernels import gemm_wgmma as gemm
from repro_torch.kernels import ssd_scan_tf32, ssd_scan_wgmma
from repro_torch.kernels.ref import (attention_ref, conv2d_ref, conv_rounded_once_share,
                                     matmul_ref64, rounded_once_share, ssd_ref,
                                     ssd_rounded_once_share)
from repro_torch.lower import (
    MaxPool2dSpec,
    RegionSpec,
    Stage,
    frequency_band_batches,
    paper_cnn_graph,
    plan_fusion,
    run_torch,
)
from repro_torch.lower.executors import PlanCache, _as_f32, _walk

SHAPES = [(128, 128, 128), (128, 128, 512), (64, 64, 256), (100, 70, 333), (8, 200, 40),
          (16384, 16, 75), (75, 16, 16384)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ops import strict_fp32

    strict_fp32()
    return torch.device("cuda", 0)


def _step_inputs(batch, img, device):
    graph = paper_cnn_graph(batch=batch, img=img)
    x, labels = frequency_band_batches(np.random.RandomState(batch), batch, img)(0)
    inputs = {
        "x": torch.as_tensor(x, device=device),
        "onehot": torch.as_tensor(np.eye(10, dtype=np.float32)[labels], device=device),
        **params_from_jax(graph.init_params(seed=1), graph, device),
    }
    return graph, inputs


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_streaming_kernel_matches_plain(cuda_device, m, n, k):
    g = torch.Generator(device="cpu").manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g).to(cuda_device)
    b = torch.randn(k, n, generator=g).to(cuda_device)
    streaming.COUNTER.reset()
    got = streaming.streaming_matmul(a, b)
    got_t = streaming.streaming_matmul(a.T.contiguous().T, b.T.contiguous().T)
    want = streaming.streaming_matmul_torch(a, b)
    torch.cuda.synchronize()
    assert streaming.COUNTER.launches == 2
    # fp32 sums in another order: the error is held against |A|.|B|
    scale = torch.matmul(a.abs(), b.abs())
    assert float(((got - want).abs() / scale).max()) <= 1e-5
    assert torch.equal(got, got_t)  # strided views take the same arithmetic


@pytest.mark.cuda
@pytest.mark.parametrize("batch,img", [(4, 16), (16, 32)])
def test_region_kernel_matches_plain(cuda_device, batch, img):
    graph, inputs = _step_inputs(batch, img, cuda_device)
    (seg,) = plan_fusion(graph).segments
    ins = {n: inputs[n] for n, _ in seg.region.inputs}
    fused.COUNTER.reset()
    got = fused.build_region_callable(seg.region, device=cuda_device)(ins)
    want = fused.region_torch(seg.region, ins)
    torch.cuda.synchronize()
    assert fused.COUNTER.launches == 1
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-6, msg=k)


@pytest.mark.cuda
def test_region_kernel_maxpool_ties_exact(cuda_device):
    spec = MaxPool2dSpec(8, 8, 32)
    st = Stage(node="p1", pass_="dx", spec=spec, in_edge="x", out_edge="a_p1")
    region = RegionSpec(stages=(st,), batch=8, lr=0.05, momentum=0.0,
                        inputs=(("x", True), ("d_a_p1", True)),
                        outputs=(("d_x", "batched"),))
    g = torch.Generator(device="cpu").manual_seed(0)
    ins = {"x": torch.randint(0, 3, (8, 8, 8, 32), generator=g).float().to(cuda_device),
           "d_a_p1": torch.randn(8, 4, 4, 32, generator=g).to(cuda_device)}
    got = fused.build_region_callable(region, device=cuda_device)(ins)["d_x"]
    want = fused.region_torch(region, ins)["d_x"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,img", [(4, 16), (16, 32)])
def test_region_smem_entry_matches_plain_and_the_arena_entry(cuda_device, batch, img):
    """The region routes to the shared-memory entry (a cluster per image); it
    and the arena entry hold region_torch's outputs; the bits are the same run
    to run and at every forced cluster size."""
    graph, inputs = _step_inputs(batch, img, cuda_device)
    (seg,) = plan_fusion(graph).segments
    ins = {n: inputs[n] for n, _ in seg.region.inputs}
    kern = fused.region_kernel(seg.region, ins, cuda_device)
    fused.COUNTER.reset()
    got = fused.build_region_callable(seg.region, device=cuda_device)(ins)
    arena = kern(ins, name=fused.ARENA)
    want = fused.region_torch(seg.region, ins)
    torch.cuda.synchronize()
    assert kern.entry == fused.SMEM and kern.cluster in (2, 4, 8)
    assert fused.COUNTER.entries == {fused.SMEM: 1, fused.ARENA: 1}
    assert fused.COUNTER.plain_calls == 1
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-6, msg=k)
        torch.testing.assert_close(arena[k], v, rtol=1e-5, atol=1e-6, msg=f"arena {k}")
    for cluster in (None, 1, 2, 4, 8):
        again = kern(ins, cluster=cluster)
        assert all(torch.equal(again[k], got[k]) for k in got), cluster


@pytest.mark.cuda
def test_region_smem_entry_maxpool_ties_exact(cuda_device):
    spec = MaxPool2dSpec(8, 8, 32)
    st = Stage(node="p1", pass_="dx", spec=spec, in_edge="x", out_edge="a_p1")
    region = RegionSpec(stages=(st,), batch=8, lr=0.05, momentum=0.0,
                        inputs=(("x", True), ("d_a_p1", True)),
                        outputs=(("d_x", "batched"),))
    g = torch.Generator(device="cpu").manual_seed(3)
    ins = {"x": torch.randint(0, 3, (8, 8, 8, 32), generator=g).float().to(cuda_device),
           "d_a_p1": torch.randn(8, 4, 4, 32, generator=g).to(cuda_device)}
    kern = fused.region_kernel(region, ins, cuda_device)
    want = fused.region_torch(region, ins)["d_x"]
    assert kern.entry == fused.SMEM
    for name in (fused.SMEM, fused.ARENA):
        torch.testing.assert_close(kern(ins, name=name)["d_x"], want, rtol=0, atol=0, msg=name)


@pytest.mark.cuda
def test_region_smem_entry_refuses_forced_regions_that_do_not_fit(cuda_device):
    graph, inputs = _step_inputs(2, 64, cuda_device)
    (seg,) = plan_fusion(graph).segments
    ins = {n: inputs[n] for n, _ in seg.region.inputs}
    kern = fused.region_kernel(seg.region, ins, cuda_device)
    assert kern.entry == fused.ARENA
    fused.COUNTER.reset()
    with pytest.raises(ValueError, match="do not fit"):
        kern(ins, name=fused.SMEM)
    got = fused.build_region_callable(seg.region, device=cuda_device)(ins)
    torch.cuda.synchronize()
    assert fused.COUNTER.entries == {fused.ARENA: 1}
    want = fused.region_torch(seg.region, ins)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-6, msg=k)


# the JAX lowering's spill set for the paper CNN at batch 16, img 32 (held
# against repro.lower by tests/test_torch_fused.py): planned with it, the
# fuser cuts the step into three small regions between per-node steps
SPILLED_16_32 = ("a_r1", "a_r2", "c2.dwb", "c2.dx.dy_pad00", "c2.dx.dy_pad01",
                 "c2.dx.dy_pad10", "c2.x_pad", "d_a_c1", "d_a_c2", "d_a_f1", "d_a_r1",
                 "d_a_r2", "p1.mask", "r1.mask", "r2.mask")


@pytest.mark.cuda
def test_spilled_plan_regions_run_on_the_smem_entry(cuda_device):
    """The JAX-spilled plan's regions (a conv forward whose output escapes,
    the fc chain with escaping logits and gradient, an update with no body
    stage) all run on the shared-memory entry, and the step matches the
    unfused one."""
    graph, inputs = _step_inputs(16, 32, cuda_device)
    segments = plan_fusion(graph, spilled=SPILLED_16_32).segments
    cache = PlanCache()
    fused.COUNTER.reset()
    got = _walk(graph, _as_f32(inputs, cuda_device),
                lambda spec, pass_: cache.get(spec, pass_, cuda_device), segments,
                keep_grads=True)
    want = run_torch(graph, inputs, fuse=False, device=cuda_device)
    torch.cuda.synchronize()
    assert sum(seg.region is not None for seg in segments) == 3
    assert fused.COUNTER.entries == {fused.SMEM: 3} and fused.COUNTER.plain_calls == 0
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6, msg=k)


@pytest.mark.cuda
def test_step_fused_matches_unfused(cuda_device):
    graph, inputs = _step_inputs(16, 32, cuda_device)
    fused_out = run_torch(graph, inputs, fuse=True, device=cuda_device)
    unfused = run_torch(graph, inputs, fuse=False, device=cuda_device)
    assert set(fused_out) == set(unfused)
    for k in fused_out:
        torch.testing.assert_close(fused_out[k], unfused[k], rtol=1e-5, atol=1e-6, msg=k)


# (B, H, G, S, P, N, chunk): the JAX kernel sweep's shapes, G 1, 2 and 4
SSD_CASES = [
    (2, 4, 2, 256, 32, 32, 64),
    (1, 2, 1, 128, 64, 128, 128),
    (1, 4, 4, 192, 16, 32, 64),
    (1, 1, 1, 64, 8, 16, 32),
]
# bf16 output rounds once: one bf16 ulp of max|y| is 2**-8 ~ 3.9e-3
SSD_TOL = {torch.float32: 3e-5, torch.bfloat16: 1e-2}


def _ssd_inputs(bs, h, g, s, p, n, seed, device, dtype=torch.float32, decay=0.5):
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(bs, h, s, p) * 0.5, dtype=torch.float32)
    la = torch.as_tensor(-np.abs(rng.rand(bs, h, s)) * decay, dtype=torch.float32)
    b = torch.as_tensor(rng.randn(bs, g, s, n) * 0.3, dtype=torch.float32)
    c = torch.as_tensor(rng.randn(bs, g, s, n) * 0.3, dtype=torch.float32)
    return (x.to(device, dtype), la.to(device), b.to(device, dtype), c.to(device, dtype))


def _rel_err(got, want):
    scale = float(want.float().abs().max()) + 1e-6
    return float((got.float() - want.float()).abs().max()) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bs,h,g,s,p,n,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda_device, bs, h, g, s, p, n, chunk, dtype):
    x, la, b, c = _ssd_inputs(bs, h, g, s, p, n, s + p, cuda_device, dtype)
    ssd_scan.COUNTER.reset()
    got = ssd_scan.ssd_scan(x, la, b, c, chunk=chunk)
    again = ssd_scan.ssd_scan(x, la, b, c, chunk=chunk)
    want = ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk)
    seq = ssd_ref(x, la, b, c)
    torch.cuda.synchronize()
    assert (ssd_scan.COUNTER.launches, ssd_scan.COUNTER.plain_calls) == (2, 1)
    assert got.dtype == dtype and got.shape == (bs, h, s, p)
    assert torch.equal(got, again)  # no atomics: the same bits run to run
    assert _rel_err(got, want) <= SSD_TOL[dtype]
    assert _rel_err(got, seq) <= SSD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_kernel_reads_transposed_views(cuda_device, dtype):
    """The (B,S,H,P) -> (B,H,S,P) views that ssm_block passes, no copy."""
    bs, h, g, s, p, n = 2, 8, 2, 256, 16, 32
    x, la, b, c = _ssd_inputs(bs, h, g, s, p, n, 3, cuda_device, dtype)
    xv = x.transpose(1, 2).contiguous().transpose(1, 2)
    lav = la.transpose(1, 2).contiguous().transpose(1, 2)
    bv = b.transpose(1, 2).contiguous().transpose(1, 2)
    cv = c.transpose(1, 2).contiguous().transpose(1, 2)
    assert not xv.is_contiguous() and not lav.is_contiguous() and not bv.is_contiguous()
    got = ssd_scan.ssd_scan(xv, lav, bv, cv, chunk=64)
    want = ssd_scan.ssd_scan(x, la, b, c, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_kernel_strong_decay_stays_finite(cuda_device, dtype):
    """la down to -4.8 per step: exp above the diagonal would overflow."""
    bs, h, g, s, p, n = 1, 48, 1, 256, 16, 32
    x, _, b, c = _ssd_inputs(bs, h, g, s, p, n, 5, cuda_device, dtype)
    a = torch.arange(1, h + 1, dtype=torch.float32, device=cuda_device)
    la = (-0.1 * a[None, :, None]).expand(bs, h, s).contiguous()
    got = ssd_scan.ssd_scan(x, la, b, c, chunk=128)
    want = ssd_scan.ssd_scan_torch(x, la, b, c, chunk=128)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= SSD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_kernel_dt_to_one_matches_ssd_ref(cuda_device, dtype):
    """dt up to 1.0 with A up to 48: la to -48 per step, |cum| in the thousands.

    Held to the sequential ssd_ref: cum_i - cum_j cancels in fp32 in every
    dual form, so the plain chunked version is no yardstick here.
    """
    bs, h, g, s, p, n = 1, 48, 1, 256, 16, 32
    x, _, b, c = _ssd_inputs(bs, h, g, s, p, n, 6, cuda_device, dtype)
    dt = torch.as_tensor(np.random.RandomState(6).rand(bs, h, s), dtype=torch.float32)
    a = torch.arange(1, h + 1, dtype=torch.float32)
    la = (-dt * a[None, :, None]).to(cuda_device)
    got = ssd_scan.ssd_scan(x, la, b, c, chunk=128)
    seq = ssd_ref(x, la, b, c)
    torch.cuda.synchronize()
    assert float(la.min()) < -40
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, seq) <= SSD_TOL[dtype]


# parameters through lm_params_from_jax, from a stacked tree like JAX's init_lm
# (one pattern position, no remainder layers); needs `cfg` defined first
_CONVERTED_PARAMS = """
own = init_lm(cfg, seed=0, device="cpu")
units = own["decoder"]["units"][0]
tree = {"embed": own["embed"], "final_norm": {"scale": own["final_norm"]["scale"]},
        "decoder": {"units": [{
            k: torch.stack([dict(layer.named_parameters())[k] for layer in units])
            for k, _ in units[0].named_parameters()}], "rem": []}}
params = lm_params_from_jax(tree, cfg, "cuda")  # no resolve_device on this route
"""

_FRESH_PREFILL = """
import torch
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.ops import strict_fp32
from repro_torch.models.config import ParallelCtx
from repro_torch.models.lm import init_lm, prefill

flag = torch.backends.cuda.matmul
print("default allow_bf16_reduced_precision_reduction:",
      flag.allow_bf16_reduced_precision_reduction)
cfg = reduce_config(get_config("mamba2_780m")).with_(dtype=torch.bfloat16)
""" + _CONVERTED_PARAMS + """
tokens = torch.randint(0, cfg.vocab_size, (2, 256), device="cuda")
first = prefill(params, tokens, cfg, ParallelCtx())
assert not flag.allow_bf16_reduced_precision_reduction and not flag.allow_tf32
strict_fp32()
assert torch.equal(first, prefill(params, tokens, cfg, ParallelCtx()))
"""


@pytest.mark.cuda
def test_prefill_on_converted_params_sums_bf16_in_fp32(cuda_device):
    """A fresh process, torch's default matmul flags, parameters from
    lm_params_from_jax: prefill itself turns bf16 reduced-precision
    reduction off, so its logits are those of a prefill after strict_fp32."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": f"{src}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(_FRESH_PREFILL)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr


@pytest.mark.cuda
def test_ssd_kernel_refuses_mixed_devices_and_types(cuda_device):
    x, la, b, c = _ssd_inputs(1, 2, 1, 64, 8, 16, 0, cuda_device)
    with pytest.raises(ValueError):
        ssd_scan.ssd_scan(x, la.cpu(), b, c, chunk=32)
    with pytest.raises(TypeError):
        ssd_scan.ssd_scan(x.half(), la, b.half(), c.half(), chunk=32)
    with pytest.raises(TypeError):
        ssd_scan.ssd_scan(x, la.double(), b, c, chunk=32)


# (B, H, G, S, P, N, chunk) the tensor-core SSD entry takes: the Mamba-2 780M's
# P 64, N 128, chunk 128; G 2 at N 64 and chunk 64; P 128, N 256; N 192
SSD_WGMMA_CASES = [
    (1, 4, 1, 256, 64, 128, 128),
    (1, 4, 2, 256, 64, 64, 64),
    (2, 4, 2, 512, 128, 256, 128),
    (1, 2, 1, 128, 64, 192, 64),
]
ROUNDED_ONCE = 1e-2  # chip_smoke.py's gate


def _model_views(x, la, b, c):
    """The (B,S,H,P) -> (B,H,S,P) views that ssm_block passes, same values."""
    return tuple(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (x, la, b, c))


@pytest.mark.cuda
@pytest.mark.parametrize("bs,h,g,s,p,n,chunk", SSD_WGMMA_CASES)
def test_ssd_wgmma_entry_matches_plain_and_ref(cuda_device, bs, h, g, s, p, n, chunk):
    x, la, b, c = _ssd_inputs(bs, h, g, s, p, n, s + p + n, cuda_device, torch.bfloat16)
    assert ssd_scan.entry(torch.bfloat16, p, n, chunk) == ssd_scan_wgmma.ENTRY
    ssd_scan.COUNTER.reset()
    got = ssd_scan.ssd_scan(x, la, b, c, chunk=chunk)
    again = ssd_scan.ssd_scan(x, la, b, c, chunk=chunk)
    want = ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk)
    seq = ssd_ref(x, la, b, c)
    torch.cuda.synchronize()
    assert ssd_scan.COUNTER.entries == {ssd_scan_wgmma.ENTRY: 2}
    assert got.dtype == torch.bfloat16 and got.shape == (bs, h, s, p)
    assert torch.equal(got, again)  # no atomics: the same bits run to run
    assert _rel_err(got, want) <= SSD_TOL[torch.bfloat16]
    assert _rel_err(got, seq) <= SSD_TOL[torch.bfloat16]
    assert ssd_rounded_once_share(got, x, la, b, c) <= ROUNDED_ONCE


@pytest.mark.cuda
def test_ssd_wgmma_strided_views_give_the_bits_of_contiguous_operands(cuda_device):
    x, la, b, c = _ssd_inputs(2, 8, 2, 256, 64, 128, 3, cuda_device, torch.bfloat16)
    views = _model_views(x, la, b, c)
    assert not any(v.is_contiguous() for v in views)
    got = ssd_scan.ssd_scan(*views, chunk=128)
    want = ssd_scan.ssd_scan(x, la, b, c, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_ssd_wgmma_strong_decay_stays_finite(cuda_device):
    """la down to -4.8 per step: exp above the diagonal would overflow."""
    bs, h, g, s, p, n = 1, 48, 1, 256, 64, 128
    x, _, b, c = _ssd_inputs(bs, h, g, s, p, n, 5, cuda_device, torch.bfloat16)
    a = torch.arange(1, h + 1, dtype=torch.float32, device=cuda_device)
    la = (-0.1 * a[None, :, None]).expand(bs, h, s).contiguous()
    got = ssd_scan.ssd_scan(x, la, b, c, chunk=128)
    want = ssd_scan.ssd_scan_torch(x, la, b, c, chunk=128)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= SSD_TOL[torch.bfloat16]


@pytest.mark.cuda
def test_ssd_wgmma_dt_to_one_matches_ssd_ref(cuda_device):
    """dt up to 1.0 with A up to 48 and G 2: la to -48 per step, held to the
    sequential ssd_ref (cum_i - cum_j cancels in fp32 in every dual form)."""
    bs, h, g, s, p, n = 1, 48, 2, 256, 64, 128
    x, _, b, c = _ssd_inputs(bs, h, g, s, p, n, 6, cuda_device, torch.bfloat16)
    dt = torch.as_tensor(np.random.RandomState(6).rand(bs, h, s), dtype=torch.float32)
    la = (-dt * torch.arange(1, h + 1, dtype=torch.float32)[None, :, None]).to(cuda_device)
    got = ssd_scan.ssd_scan(x, la, b, c, chunk=128)
    seq = ssd_ref(x, la, b, c)
    torch.cuda.synchronize()
    assert float(la.min()) < -40
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, seq) <= SSD_TOL[torch.bfloat16]


@pytest.mark.cuda
def test_ssd_wgmma_matches_its_emulation_and_the_gate_rejects_one_term(cuda_device):
    x, la, b, c = _ssd_inputs(1, 8, 1, 512, 64, 128, 7, cuda_device, torch.bfloat16)
    got = ssd_scan.ssd_scan(x, la, b, c, chunk=128)
    emu = ssd_scan_wgmma.emulate(x, la, b, c, chunk=128)
    one = ssd_scan_wgmma.emulate(x, la, b, c, chunk=128, terms=1)
    torch.cuda.synchronize()
    assert float((got != emu).double().mean()) <= 1e-3  # fp32 sums in another order
    assert ssd_rounded_once_share(got, x, la, b, c) <= ROUNDED_ONCE
    assert ssd_rounded_once_share(one, x, la, b, c) > ROUNDED_ONCE


@pytest.mark.cuda
def test_ssd_launches_are_counted_per_entry(cuda_device):
    """Each dtype on its tensor-core entry where that takes the shape (fp32
    3xTF32, bf16 wgmma) and on its FFMA entry elsewhere, or when named."""
    ssd_scan.COUNTER.reset()
    for dtype, p, n, chunk in ((torch.float32, 64, 128, 128), (torch.bfloat16, 64, 128, 128),
                               (torch.bfloat16, 32, 32, 64), (torch.bfloat16, 64, 64, 64),
                               (torch.float32, 32, 32, 64)):
        ssd_scan.ssd_scan(*_ssd_inputs(1, 2, 1, 128, p, n, 1, cuda_device, dtype), chunk=chunk)
    x, la, b, c = _ssd_inputs(1, 2, 1, 128, 64, 128, 1, cuda_device, torch.bfloat16)
    ffma = ssd_scan.launch("ssd_scan_bf16", x, la, b, c)
    torch.cuda.synchronize()
    assert ssd_scan.COUNTER.entries == {
        ssd_scan_tf32.ENTRY: 1, "ssd_scan_f32": 1, "ssd_scan_bf16": 2, ssd_scan_wgmma.ENTRY: 2}
    assert (ssd_scan.COUNTER.launches, ssd_scan.COUNTER.plain_calls) == (6, 0)
    assert _rel_err(ffma, ssd_scan.ssd_scan_torch(x, la, b, c)) <= SSD_TOL[torch.bfloat16]


@pytest.mark.cuda
def test_ssd_wgmma_refuses_operands_tma_cannot_read(cuda_device):
    x, la, b, c = _ssd_inputs(1, 2, 1, 128, 64, 128, 2, cuda_device, torch.bfloat16)
    wide = torch.zeros(1, 1, 128, 136, dtype=torch.bfloat16, device=cuda_device)[..., :128]
    wide.copy_(b)
    assert wide.stride(2) * 2 % 16 == 0  # 272-byte rows: TMA reads them
    ssd_scan.ssd_scan(x, la, wide, c)
    odd = torch.zeros(1, 1, 128, 132, dtype=torch.bfloat16, device=cuda_device)[..., :128]
    odd.copy_(b)  # rows of 264 bytes
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    shifted = shifted.view(x.shape)
    shifted.copy_(x)
    ssd_scan.COUNTER.reset()
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ssd_scan.ssd_scan(x, la, odd, c)
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        ssd_scan.ssd_scan(shifted, la, b, c)
    with pytest.raises(ValueError, match="unit last stride"):
        ssd_scan.ssd_scan(x, la, b, c.transpose(2, 3).contiguous().transpose(2, 3))
    assert ssd_scan.COUNTER.launches == 0


# (B, Hq, Hkv, Sq, Skv, D, causal, window): tests/kernels/test_flash_attention.py,
# recurrentgemma's D-256 MQA window, a KV tail and rows with no visible key
ATTN_CASES = [
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 4, 256, 256, 64, True, None),
    (1, 4, 4, 128, 384, 64, True, 128),
    (2, 2, 1, 128, 128, 128, False, None),
    (1, 2, 2, 64, 192, 32, True, 64),
    (1, 10, 1, 1024, 1024, 256, True, 512),
    (1, 2, 2, 640, 640, 16, True, None),
    (1, 3, 1, 600, 600, 32, True, 100),  # partial query and key tiles of the kernel
    (1, 2, 1, 256, 64, 64, True, 32),
]
ATTN_IDS = [f"b{c[0]}-h{c[1]}/{c[2]}-s{c[3]}/{c[4]}-d{c[5]}-{'c' if c[6] else 'nc'}-w{c[7]}"
            for c in ATTN_CASES]


def _attn_inputs(b, hq, hkv, sq, skv, d, seed, device, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return tuple(torch.as_tensor(rng.randn(b, h, s, d) * 0.3, dtype=torch.float32)
                 .to(device, dtype) for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))


def _attn_close(got, want):
    """fp32: the band of the JAX kernel sweep; bf16: one rounding of o, 1e-2 of max|o|."""
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-3)
    else:
        assert _rel_err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", ATTN_CASES, ids=ATTN_IDS)
def test_attention_kernel_matches_plain(cuda_device, b, hq, hkv, sq, skv, d, causal, window,
                                        dtype):
    q, k, v = _attn_inputs(b, hq, hkv, sq, skv, d, sq + skv + d, cuda_device, dtype)
    kw = {"causal": causal, "window": window}
    flash_attention.COUNTER.reset()
    got = flash_attention.flash_attention(q, k, v, **kw)
    again = flash_attention.flash_attention(q, k, v, **kw)
    want = flash_attention.flash_attention_torch(q, k, v, **kw)
    dense = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    per_call = sum(flash_attention.launches_of(dtype, sq, skv, d, **kw).values())
    assert (flash_attention.COUNTER.launches, flash_attention.COUNTER.plain_calls) == (
        2 * per_call, 1)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)  # no atomics: the same bits run to run
    _attn_close(got, want)
    _attn_close(got, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_kernel_reads_transposed_views(cuda_device, dtype):
    """The (B,S,H,D) -> (B,H,S,D) views that attention_block passes, no copy."""
    q, k, v = _attn_inputs(2, 8, 2, 256, 256, 64, 3, cuda_device, dtype)
    qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert not (qv.is_contiguous() or kv.is_contiguous() or vv.is_contiguous())
    got = flash_attention.flash_attention(qv, kv, vv, window=100)
    want = flash_attention.flash_attention(q, k, v, window=100)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_attention_rows_with_no_visible_key_are_zero(cuda_device):
    q, k, v = _attn_inputs(1, 4, 2, 256, 64, 128, 4, cuda_device)
    got = flash_attention.flash_attention(q, k, v, causal=True, window=32)
    torch.cuda.synchronize()
    assert not bool(got[:, :, 95:].any())
    assert bool((got[:, :, :95].abs().amax(dim=-1) > 0).all())


@pytest.mark.cuda
def test_attention_kernel_refuses_bad_operands(cuda_device):
    q, k, v = _attn_inputs(1, 4, 2, 64, 64, 64, 0, cuda_device)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, k.bfloat16(), v)
    q48, k48, v48 = _attn_inputs(1, 4, 2, 64, 64, 48, 0, cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q48, k48, v48)


# the tensor-core entry (bf16 at D 64 / 128): GQA, a window, a KV tail of
# 600 (9 x 64 + 24, in q and in kv), non-causal with Skv != Sq
WGMMA_CASES = [
    (1, 8, 2, 512, 512, 64, True, None),
    (1, 32, 8, 1024, 1024, 128, True, None),
    (1, 4, 4, 640, 640, 128, True, 200),
    (1, 2, 2, 600, 600, 64, True, None),
    (2, 2, 1, 128, 384, 128, False, None),
]
WGMMA_IDS = [f"b{c[0]}-h{c[1]}/{c[2]}-s{c[3]}/{c[4]}-d{c[5]}-{'c' if c[6] else 'nc'}-w{c[7]}"
             for c in WGMMA_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", WGMMA_CASES, ids=WGMMA_IDS)
def test_wgmma_entry_matches_plain(cuda_device, b, hq, hkv, sq, skv, d, causal, window):
    """bf16 through the tensor-core entry vs plain and attention_ref (1e-2 of
    max|o|), the same bits run to run, and at most 1 % of o's elements off
    the fp64 attention rounded once to bf16."""
    q, k, v = _attn_inputs(b, hq, hkv, sq, skv, d, sq + skv + d, cuda_device, torch.bfloat16)
    kw = {"causal": causal, "window": window}
    flash_attention.COUNTER.reset()
    got = flash_attention.flash_attention(q, k, v, **kw)
    again = flash_attention.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.COUNTER.entries == {wgmma.ENTRY: 2}
    assert flash_attention.COUNTER.plain_calls == 0
    assert torch.equal(got, again)
    _attn_close(got, flash_attention.flash_attention_torch(q, k, v, **kw))
    _attn_close(got, attention_ref(q, k, v, **kw))
    assert rounded_once_share(got, q, k, v, **kw) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", wgmma.HEAD_DIMS)
def test_wgmma_entry_reads_strided_views(cuda_device, d):
    """attention_block's (B,S,H,D) -> (B,H,S,D) views load by TMA with no copy."""
    q, k, v = _attn_inputs(2, 8, 2, 256, 256, d, 3, cuda_device, torch.bfloat16)
    qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert not (qv.is_contiguous() or kv.is_contiguous() or vv.is_contiguous())
    got = flash_attention.flash_attention(qv, kv, vv, window=100)
    want = flash_attention.flash_attention(q, k, v, window=100)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", wgmma.HEAD_DIMS)
def test_wgmma_rows_with_no_visible_key_are_zero(cuda_device, d):
    q, k, v = _attn_inputs(1, 4, 2, 256, 64, d, 4, cuda_device, torch.bfloat16)
    flash_attention.COUNTER.reset()
    got = flash_attention.flash_attention(q, k, v, causal=True, window=32)
    torch.cuda.synchronize()
    assert flash_attention.COUNTER.entries == {wgmma.ENTRY: 1}
    assert not bool(got[:, :, 95:].any())
    assert bool((got[:, :, :95].abs().amax(dim=-1) > 0).all())


@pytest.mark.cuda
def test_wgmma_entry_refuses_operands_tma_cannot_read(cuda_device):
    q, k, v = _attn_inputs(1, 2, 2, 128, 128, 64, 0, cuda_device, torch.bfloat16)
    wide = torch.zeros(1, 2, 128, 68, dtype=torch.bfloat16, device=cuda_device)[..., :64]
    shifted = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16,
                          device=cuda_device)[1:].view(1, 2, 128, 64)
    flash_attention.COUNTER.reset()
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash_attention.flash_attention(q, wide, v)
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        flash_attention.flash_attention(q, k, shifted)
    assert flash_attention.COUNTER.launches == 0


@pytest.mark.cuda
def test_attention_launches_are_counted_per_entry(cuda_device):
    """At D 64 and 128 fp32 on the 3xTF32 entry and bf16 on the bf16 tensor-core
    entry; at D 32 and 256 on the FFMA entries of each dtype."""
    flash_attention.COUNTER.reset()
    for dtype, d in ((torch.float32, 32), (torch.float32, 64), (torch.bfloat16, 32),
                     (torch.bfloat16, 64), (torch.bfloat16, 128), (torch.bfloat16, 256)):
        flash_attention.flash_attention(*_attn_inputs(1, 2, 1, 128, 128, d, 1, cuda_device, dtype))
    torch.cuda.synchronize()
    # the causal fp32 call at D 64 also launches the FFMA entry for its first
    # 96 rows (flash_attention.ffma_rows)
    assert flash_attention.COUNTER.entries == {
        "flash_attention_f32": 2, attn_tf32.ENTRY: 1, "flash_attention_bf16": 2, wgmma.ENTRY: 2}
    assert flash_attention.COUNTER.launches == 7


_FRESH_QWEN_PREFILL = """
import torch
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import flash_attention
from repro_torch.models.config import ParallelCtx
from repro_torch.models.lm import init_lm, prefill

cfg = get_config("qwen1_5_0_5b").with_(n_layers=2)
""" + _CONVERTED_PARAMS + """
tokens = torch.randint(0, cfg.vocab_size, (2, 512), device="cuda")
first = prefill(params, tokens, cfg, ParallelCtx())
assert flash_attention.COUNTER.launches == 2 and flash_attention.COUNTER.plain_calls == 0
assert bool(torch.isfinite(first).all())
flash_attention.flash_attention = flash_attention.flash_attention_torch
plain = prefill(params, tokens, cfg, ParallelCtx())
err = float((first - plain).abs().max()) / float(plain.abs().max())
assert err <= 2e-2, err
"""


@pytest.mark.cuda
def test_qwen_prefill_on_converted_params(cuda_device):
    """A fresh process, Qwen1.5-0.5B at full width (2 layers) on parameters from
    lm_params_from_jax: every attention layer launches the kernel, and the
    bf16 logits are within 2e-2 of max|logits| of the plain-attention prefill."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": f"{src}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(_FRESH_QWEN_PREFILL)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr


# ntx_matmul: tests/kernels/test_ntx_matmul.py's shapes, a long K and a GoogLeNet 1x1
MM_SHAPES = [(128, 128, 128), (128, 128, 512), (256, 128, 384), (64, 64, 64), (100, 70, 333),
             (8, 200, 40), (300, 65, 2048), (1568, 64, 256)]


def _mm_inputs(m, n, k, dtype, device, seed=0):
    rng = np.random.RandomState(m + n + k + seed)
    return (torch.as_tensor(rng.randn(m, k), dtype=torch.float32).to(device, dtype),
            torch.as_tensor(rng.randn(k, n), dtype=torch.float32).to(device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "comp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,n,k", MM_SHAPES)
def test_ntx_matmul_kernel_matches_plain(cuda_device, m, n, k, dtype, compensated):
    """ops.matmul's kernel vs the plain version in the same mode, at the band of
    tests/kernels/test_ntx_matmul.py, and the same bits on a second run."""
    a, b = _mm_inputs(m, n, k, dtype, cuda_device)
    ntx_matmul.COUNTER.reset()
    got = ops.matmul(a, b, compensated=compensated)
    again = ops.matmul(a, b, compensated=compensated)
    assert (ntx_matmul.COUNTER.launches, ntx_matmul.COUNTER.plain_calls) == (2, 0)
    want = ntx_matmul.ntx_matmul_torch(a, b, block_k=ops.matmul_block_k(k),
                                       compensated=compensated)
    tol = (2e-5 if dtype == torch.float32 else 2e-2) * k ** 0.5
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-2)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ntx_matmul_compensation_is_exact(cuda_device, dtype):
    """Integers below 256, K = 1,728 in tiles of 128: the compensated kernel
    is the fp64 product rounded once; the plain-mode kernel is not."""
    rng = np.random.RandomState(3)
    a = torch.as_tensor(rng.randint(0, 256, (300, 1728)), dtype=dtype, device=cuda_device)
    b = torch.as_tensor(rng.randint(0, 256, (1728, 70)), dtype=dtype, device=cuda_device)
    exact = matmul_ref64(a, b).float()
    comp = ops.matmul(a, b, compensated=True)
    assert torch.equal(comp, exact)
    assert torch.equal(comp, ntx_matmul.ntx_matmul_torch(a, b, block_k=128, compensated=True))
    assert not torch.equal(ops.matmul(a, b), exact)


@pytest.mark.cuda
@pytest.mark.parametrize("block_k", [1, 16, 100, 1728, 4096])
def test_ntx_matmul_kernel_block_k(cuda_device, block_k):
    """K tiles of any width, a ragged last one, and one wider than K."""
    a, b = _mm_inputs(130, 70, 1728, torch.float32, cuda_device, seed=block_k)
    for comp in (False, True):
        got = ntx_matmul.tiled_matmul(a, b, block_k=block_k, compensated=comp)
        want = ntx_matmul.ntx_matmul_torch(a, b, block_k=block_k, compensated=comp)
        torch.testing.assert_close(got, want, atol=2e-5 * 1728 ** 0.5, rtol=1e-2)


@pytest.mark.cuda
def test_ntx_matmul_kernel_views_out_dtype_and_refusals(cuda_device):
    a, b = _mm_inputs(257, 130, 45, torch.float32, cuda_device)
    at, bt = a.T.contiguous().T, b.T.contiguous().T  # column-major views
    assert torch.equal(ops.matmul(at, bt), ops.matmul(a, b))
    for dtype in (torch.float32, torch.bfloat16):
        a, b = _mm_inputs(100, 70, 333, dtype, cuda_device)
        for comp in (False, True):
            got = ops.matmul(a, b, compensated=comp, out_dtype=torch.bfloat16)
            want = ntx_matmul.ntx_matmul_torch(a, b, block_k=128, compensated=comp,
                                               out_dtype=torch.bfloat16)
            assert got.dtype == torch.bfloat16
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2 * 333 ** 0.5,
                                       rtol=1e-2)
    with pytest.raises(TypeError):
        ops.matmul(a.float(), b.bfloat16())
    with pytest.raises(TypeError):
        ops.matmul(a.half(), b.half())
    with pytest.raises(ValueError):
        ops.matmul(a, b.cpu())


# the GEMM of K-tile partials behind ntx_matmul and streaming_matmul: long-K
# products that split (the training step's c1 / c2 dW through a.T views) and two
# that do not
GEMM_SPLIT_CASES = [(75, 16, 16384, True), (144, 32, 4096, True), (300, 65, 2048, False),
                    (130, 70, 1728, False)]


def _gemm_inputs(m, n, k, dtype, device, a_t):
    """A (M, K) and B (K, N); A as the transposed view of a (K, M) tensor if ``a_t``."""
    rng = np.random.RandomState(m + n + k)
    a = torch.as_tensor(rng.randn(k, m) if a_t else rng.randn(m, k), dtype=torch.float32)
    b = torch.as_tensor(rng.randn(k, n), dtype=torch.float32)
    a = a.to(device, dtype)
    return (a.T if a_t else a), b.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,n,k,a_t", GEMM_SPLIT_CASES)
def test_gemm_forced_splits_give_identical_bits(cuda_device, m, n, k, a_t, dtype):
    """Each K tile's partial does not depend on the CTA that forms it, and the
    second pass joins them in tile order: any split gives the bits of split 1."""
    a, b = _gemm_inputs(m, n, k, dtype, cuda_device, a_t)
    for comp in (False, True):
        one = gemm.launch(a, b, block_k=128, compensated=comp, split=1)
        for split in (2, 7, 64, None):
            assert torch.equal(gemm.launch(a, b, block_k=128, compensated=comp, split=split),
                               one), (split, comp)
        want = ntx_matmul.ntx_matmul_torch(a, b, block_k=128, compensated=comp)
        torch.testing.assert_close(one, want, atol=(2e-5 if dtype == torch.float32 else 2e-2)
                                   * k ** 0.5, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gemm_views_take_the_arithmetic_of_contiguous_operands(cuda_device, dtype):
    """Column-major views, and rows whose starts are not 16-byte aligned (a
    slice of a wider tensor), take the loads' element path; the layout in
    shared memory is the same, and so are the bits, in every mode."""
    a, b = _mm_inputs(257, 130, 300, dtype, cuda_device)
    wide = torch.zeros(257, 301, dtype=dtype, device=cuda_device)
    wide[:, 1:] = a
    for comp in (False, True):
        for out in (torch.float32, torch.bfloat16):
            want = gemm.launch(a, b, block_k=128, compensated=comp, out_dtype=out)
            for va, vb in ((a.T.contiguous().T, b), (a, b.T.contiguous().T),
                           (a.T.contiguous().T, b.T.contiguous().T), (wide[:, 1:], b)):
                got = gemm.launch(va, vb, block_k=128, compensated=comp, out_dtype=out)
                assert got.dtype == out and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(8192, 192, 576), (8192, 64, 256), (16384, 64, 147)])
def test_gemm_rms_gate_and_its_one_tf32_control(cuda_device, m, n, k):
    """chip_smoke.py's RMS gate on GoogLeNet L0-L2 widths at a reduced M: the
    kernel's RMS error against fp64 at most 1.05x the plain version's, fp32 and
    bf16, plain and compensated; the 1xTF32 control is rejected by it and by
    the band."""
    for dtype in (torch.float32, torch.bfloat16):
        a, b = _mm_inputs(m, n, k, dtype, cuda_device)
        bk = ops.matmul_block_k(k)
        ref = matmul_ref64(a, b)
        rms = lambda x: float((x.double() - ref).square().mean().sqrt())  # noqa: E731
        for comp in (False, True):
            want = ntx_matmul.ntx_matmul_torch(a, b, block_k=bk, compensated=comp)
            got = ops.matmul(a, b, compensated=comp)
            assert rms(got) <= 1.05 * rms(want), (dtype, comp)
        if dtype == torch.float32:
            ctl = gemm.emulate(a, b, block_k=bk, terms=1)
            want = ntx_matmul.ntx_matmul_torch(a, b, block_k=bk)
            assert rms(ctl) > 1.05 * rms(want)
            band = ((ctl - want).abs() / (2e-5 * k ** 0.5 + 1e-2 * want.abs())).max()
            assert float(band) > 1


@pytest.mark.cuda
def test_gemm_launches_are_counted_per_entry(cuda_device):
    """ops.matmul and streaming_matmul launch the tensor-core entry, and its
    second pass where the call splits (16 K tiles over 6 tiles of C: split
    16); the FFMA entries, named directly, still run and match their plain
    versions as before."""
    a, b = _mm_inputs(300, 65, 2048, torch.float32, cuda_device)
    assert gemm.plan_split(300, 65, 2048, 128, gemm.sm_count(0)) == 16
    ntx_matmul.COUNTER.reset()
    streaming.COUNTER.reset()
    ops.matmul(a, b)
    ops.matmul(a.bfloat16(), b.bfloat16(), compensated=True)
    streaming.streaming_matmul(a, b)
    assert ntx_matmul.COUNTER.entries == {gemm.ENTRY: 2, gemm.JOIN: 2}
    assert streaming.COUNTER.entries == {gemm.ENTRY: 1, gemm.JOIN: 1}
    streaming.launch(gemm.ENTRY, a, b, split=1)  # one part: no second pass
    assert streaming.COUNTER.entries == {gemm.ENTRY: 2, gemm.JOIN: 1}
    for comp in (False, True):
        ffma = ntx_matmul.launch(ntx_matmul.FFMA, a, b, block_k=128, compensated=comp)
        want = ntx_matmul.ntx_matmul_torch(a, b, block_k=128, compensated=comp)
        torch.testing.assert_close(ffma, want, atol=2e-5 * 2048 ** 0.5, rtol=1e-2)
    ffma = streaming.launch(streaming.FFMA, a, b)
    scale = torch.matmul(a.abs(), b.abs())
    assert float(((ffma - streaming.streaming_matmul_torch(a, b)).abs() / scale).max()) <= 1e-5
    torch.cuda.synchronize()
    assert ntx_matmul.COUNTER.entries == {gemm.ENTRY: 2, gemm.JOIN: 2, ntx_matmul.FFMA: 2}
    assert streaming.COUNTER.entries == {gemm.ENTRY: 2, gemm.JOIN: 1, streaming.FFMA: 1}
    assert (ntx_matmul.COUNTER.launches, streaming.COUNTER.launches) == (4, 3)
    with pytest.raises(ValueError, match="no C entry"):
        ntx_matmul.launch("ntx_matmul_nope", a, b, block_k=128)
    with pytest.raises(ValueError, match="only ntx_gemm_wgmma splits"):
        streaming.launch(streaming.FFMA, a, b, split=2)
    with pytest.raises(TypeError, match="float32"):
        streaming.streaming_matmul(a.bfloat16(), b.bfloat16())


# conv2d_ntx: tests/kernels/test_conv2d.py's cases and a GoogLeNet-like stem
CONV_CASES = [(1, 12, 12, 3, 3, 3, 8, 1), (2, 16, 10, 4, 3, 3, 8, 2), (1, 9, 9, 3, 1, 1, 16, 1),
              (1, 14, 14, 3, 5, 5, 4, 2), (2, 11, 13, 2, 3, 2, 4, 3), (1, 8, 8, 8, 7, 7, 4, 1),
              (2, 38, 38, 3, 7, 7, 64, 2), (2, 16, 16, 64, 3, 3, 192, 1)]


def _conv_inputs(n, h, w, cin, kh, kw, cout, stride, dtype, device):
    rng = np.random.RandomState(h * 10 + kh + stride)
    x = torch.as_tensor(rng.randn(n, h, w, cin), dtype=torch.float32).to(device, dtype)
    wt = torch.as_tensor(rng.randn(kh, kw, cin, cout) * 0.2, dtype=torch.float32)
    return x, wt.to(device, dtype)


def _conv_close(got, want):
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert _rel_err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,kh,kw,cout,stride", CONV_CASES)
def test_conv2d_kernel_matches_plain(cuda_device, n, h, w, cin, kh, kw, cout, stride, dtype):
    x, wt = _conv_inputs(n, h, w, cin, kh, kw, cout, stride, dtype, cuda_device)
    conv2d.COUNTER.reset()
    got = conv2d.conv2d_ntx(x, wt, stride=stride, tile_h=4)
    assert (conv2d.COUNTER.launches, conv2d.COUNTER.plain_calls) == (1, 0)
    _conv_close(got, conv2d.conv2d_ntx_torch(x, wt, stride=stride, tile_h=4))
    _conv_close(got, conv2d_ref(x.double(), wt.double(), stride=stride).to(dtype))
    assert torch.equal(got, conv2d.conv2d_ntx(x, wt, stride=stride, tile_h=4))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_h", [1, 3, 8, 100])
def test_conv2d_kernel_row_tiles_and_strided_input(cuda_device, tile_h):
    """Every tile_h gives the same bits (each output sums in one order), and an
    NHWC view of NCHW data gives the bits of its contiguous copy."""
    rng = np.random.RandomState(tile_h)
    x = torch.as_tensor(rng.randn(2, 3, 45, 45), dtype=torch.float32,
                        device=cuda_device).permute(0, 2, 3, 1)
    wt = torch.as_tensor(rng.randn(7, 7, 3, 70) * 0.2, dtype=torch.float32, device=cuda_device)
    got = conv2d.conv2d_ntx(x, wt, stride=2, tile_h=tile_h)
    assert torch.equal(got, conv2d.conv2d_ntx(x.contiguous(), wt, stride=2, tile_h=8))
    _conv_close(got, conv2d.conv2d_ntx_torch(x, wt, stride=2, tile_h=tile_h))


@pytest.mark.cuda
def test_conv2d_kernel_refuses_mixed_devices_and_types(cuda_device):
    x, wt = _conv_inputs(1, 12, 12, 3, 3, 3, 8, 1, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        conv2d.conv2d_ntx(x, wt.cpu())
    with pytest.raises(TypeError):
        conv2d.conv2d_ntx(x, wt.bfloat16())
    with pytest.raises(TypeError):
        conv2d.conv2d_ntx(x.half(), wt.half())


# the tensor-core entry (bf16, Cin and Cout multiples of 64): Cin 64 / 128 /
# 256 / 512, Cout 64 / 128 / 192, stride 1 and 2, 1 x 1 and 3 x 3; no pixel
# count is a multiple of 128, so every case has a ragged last tile
CONV_WGMMA_CASES = [(1, 10, 10, 64, 3, 3, 64, 1), (2, 11, 9, 64, 3, 3, 192, 1),
                    (1, 13, 13, 128, 3, 3, 64, 2), (2, 9, 9, 128, 1, 1, 192, 2),
                    (1, 7, 7, 256, 1, 1, 64, 1), (3, 16, 16, 64, 3, 3, 192, 1),
                    (2, 12, 12, 512, 1, 1, 192, 1), (1, 15, 17, 128, 3, 3, 128, 1),
                    (2, 13, 13, 256, 3, 3, 192, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,kh,kw,cout,stride", CONV_WGMMA_CASES)
def test_conv2d_wgmma_entry_matches_plain(cuda_device, n, h, w, cin, kh, kw, cout, stride):
    """bf16 through the tensor-core entry vs plain and the fp64 conv (1e-2 of
    max|y|), at most 1 % of y's elements off the fp64 conv rounded once, and
    the same bits run to run and for every tile_h."""
    x, wt = _conv_inputs(n, h, w, cin, kh, kw, cout, stride, torch.bfloat16, cuda_device)
    conv2d.COUNTER.reset()
    got = conv2d.conv2d_ntx(x, wt, stride=stride)
    again = conv2d.conv2d_ntx(x, wt, stride=stride)
    torch.cuda.synchronize()
    assert conv2d.COUNTER.entries == {conv_wgmma.ENTRY: 2}
    assert conv2d.COUNTER.plain_calls == 0
    assert torch.equal(got, again)
    _conv_close(got, conv2d.conv2d_ntx_torch(x, wt, stride=stride))
    _conv_close(got, conv2d_ref(x.double(), wt.double(), stride=stride).to(torch.bfloat16))
    assert conv_rounded_once_share(got, x, wt, stride) <= 1e-2
    for tile_h in (1, 3, 100):
        assert torch.equal(got, conv2d.conv2d_ntx(x, wt, stride=stride, tile_h=tile_h))


@pytest.mark.cuda
def test_conv2d_wgmma_entry_reads_padded_views(cuda_device):
    """A padded plane's interior (pixel strides of the full plane, base moved)
    gives the bits of its contiguous copy."""
    x, wt = _conv_inputs(2, 20, 20, 128, 3, 3, 192, 1, torch.bfloat16, cuda_device)
    inner = x[:, 2:-2, 1:-1]
    assert not inner.is_contiguous()
    got = conv2d.conv2d_ntx(inner, wt)
    torch.cuda.synchronize()
    assert torch.equal(got, conv2d.conv2d_ntx(inner.contiguous(), wt))


@pytest.mark.cuda
def test_conv2d_wgmma_entry_refuses_operands_it_cannot_read(cuda_device):
    x, wt = _conv_inputs(1, 12, 12, 64, 3, 3, 64, 1, torch.bfloat16, cuda_device)
    wide = torch.zeros(1, 12, 12, 68, dtype=torch.bfloat16, device=cuda_device)[..., :64]
    shifted = torch.zeros(12 * 12 * 64 + 1, dtype=torch.bfloat16,
                          device=cuda_device)[1:].view(1, 12, 12, 64)
    conv2d.COUNTER.reset()
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        conv2d.conv2d_ntx(wide, wt)
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        conv2d.conv2d_ntx(shifted, wt)
    with pytest.raises(ValueError, match="takes bf16 with Cin and Cout multiples of 64"):
        conv2d.launch(conv_wgmma.ENTRY, x.float(), wt.float())
    assert conv2d.COUNTER.launches == 0


@pytest.mark.cuda
def test_conv2d_launches_are_counted_per_entry(cuda_device):
    """Cin 3 at 3 x 3 (K 27) on the stem entry in bf16 and on FFMA in fp32 (a
    short sum), Cout 100 on the FFMA entry; Cin 64 on the tensor cores, fp32
    on the 3xTF32 entry (its split of w counted apart) and bf16 on the bf16
    one; the FFMA entry named directly takes bf16 at Cin 64 too."""
    conv2d.COUNTER.reset()
    for dtype, cin, cout in ((torch.float32, 64, 64), (torch.float32, 3, 64),
                             (torch.bfloat16, 3, 64), (torch.bfloat16, 64, 64),
                             (torch.bfloat16, 64, 100)):
        conv2d.conv2d_ntx(*_conv_inputs(1, 10, 10, cin, 3, 3, cout, 1, dtype, cuda_device))
    x, wt = _conv_inputs(1, 10, 10, 64, 3, 3, 64, 1, torch.bfloat16, cuda_device)
    ffma = conv2d.launch(conv2d.FFMA, x, wt)
    torch.cuda.synchronize()
    assert conv2d.COUNTER.entries == {conv2d.FFMA: 3, conv_wgmma.ENTRY: 1, conv_tf32.ENTRY: 1,
                                      conv_tf32.SPLIT: 1, conv_stem.ENTRY: 1}
    assert conv2d.COUNTER.launches == 6
    _conv_close(ffma, conv2d.conv2d_ntx_torch(x, wt))


def _rms_ratio(got, ref64, plain) -> float:
    """RMS error against the fp64 result over the plain version's (chip_smoke.py's gate)."""
    rms = lambda t: float(t.double().square().mean().sqrt())  # noqa: E731
    return rms(got.double() - ref64) / rms(plain.double() - ref64)


# the 3xTF32 attention entry (fp32 at D 64 / 128): GQA, a window, a KV tail of
# 600 (9 x 64 + 24, in q and in kv), non-causal with Skv != Sq
TF32_ATTN_CASES = [
    (1, 8, 2, 512, 512, 64, True, None),
    (1, 32, 8, 1024, 1024, 128, True, None),
    (1, 4, 4, 640, 640, 128, True, 200),
    (1, 2, 2, 600, 600, 64, True, None),
    (2, 2, 1, 128, 384, 128, False, None),
]
TF32_ATTN_IDS = [f"b{c[0]}-h{c[1]}/{c[2]}-s{c[3]}/{c[4]}-d{c[5]}-{'c' if c[6] else 'nc'}-w{c[7]}"
                 for c in TF32_ATTN_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", TF32_ATTN_CASES, ids=TF32_ATTN_IDS)
def test_tf32_attention_entry_matches_plain(cuda_device, b, hq, hkv, sq, skv, d, causal, window):
    """fp32 through the 3xTF32 entry vs plain and attention_ref at the fp32 band,
    the same bits run to run and on contiguous copies of the strided views,
    and an RMS error against fp64 at most 1.05 x the plain version's."""
    q, k, v = _attn_inputs(b, hq, hkv, sq, skv, d, sq + skv + d, cuda_device)
    qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    kw = {"causal": causal, "window": window}
    flash_attention.COUNTER.reset()
    got = flash_attention.flash_attention(qv, kv, vv, **kw)
    again = flash_attention.flash_attention(qv, kv, vv, **kw)
    contiguous = flash_attention.flash_attention(q, k, v, **kw)
    want = flash_attention.flash_attention_torch(q, k, v, **kw)
    ref64 = attention_ref(q, k, v, compute_dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    per_call = flash_attention.launches_of(torch.float32, sq, skv, d, **kw)
    assert flash_attention.COUNTER.entries == {name: 3 * n for name, n in per_call.items()}
    assert flash_attention.COUNTER.plain_calls == 1
    assert torch.equal(got, again) and torch.equal(got, contiguous)
    _attn_close(got, want)
    _attn_close(got, attention_ref(q, k, v, **kw))
    assert _rms_ratio(got, ref64, want) <= 1.05


@pytest.mark.cuda
@pytest.mark.parametrize("d", attn_tf32.HEAD_DIMS)
def test_tf32_attention_rows_with_no_visible_key_are_zero(cuda_device, d):
    """By name: flash_attention sends fp32 with a window of 32 to FFMA."""
    q, k, v = _attn_inputs(1, 4, 2, 256, 64, d, 4, cuda_device)
    flash_attention.COUNTER.reset()
    got = flash_attention.launch(attn_tf32.ENTRY, q, k, v, causal=True, window=32)
    torch.cuda.synchronize()
    assert flash_attention.COUNTER.entries == {attn_tf32.ENTRY: 1}
    assert not bool(got[:, :, 95:].any())
    assert bool((got[:, :, :95].abs().amax(dim=-1) > 0).all())
    _attn_close(got, flash_attention.flash_attention_torch(q, k, v, causal=True, window=32))


@pytest.mark.cuda
def test_tf32_attention_entry_refuses_operands_it_cannot_read(cuda_device):
    q, k, v = _attn_inputs(1, 2, 2, 128, 128, 64, 0, cuda_device)
    wide = torch.zeros(1, 2, 128, 66, device=cuda_device)[..., :64]
    shifted = torch.zeros(2 * 128 * 64 + 1, device=cuda_device)[1:].view(1, 2, 128, 64)
    flash_attention.COUNTER.reset()
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash_attention.flash_attention(q, wide, v)
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        flash_attention.flash_attention(q, k, shifted)
    with pytest.raises(ValueError, match="takes fp32 at head dims"):
        flash_attention.launch(attn_tf32.ENTRY, q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert flash_attention.COUNTER.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", attn_tf32.HEAD_DIMS)
def test_tf32_attention_kernel_holds_the_registers_its_split_needs(cuda_device, d):
    """The built kernel has at least the registers its setmaxnreg split takes
    (below them a launch is refused, where the block would hang)."""
    regs, needed = attn_tf32.kernel_registers(d)
    assert needed == attn_tf32.registers_needed(d)
    assert needed <= regs <= 255


# the 3xTF32 conv entry (fp32, Cin a multiple of 32, Cout of 64): Cin 32 / 64 /
# 128 / 256 / 512, Cout 64 / 128 / 192, stride 1 and 2, 1 x 1 and 3 x 3; no
# pixel count is a multiple of 128, so every case has a ragged last tile
CONV_TF32_CASES = [(1, 10, 10, 64, 3, 3, 64, 1), (2, 11, 9, 64, 3, 3, 192, 1),
                   (1, 13, 13, 128, 3, 3, 64, 2), (2, 9, 9, 128, 1, 1, 192, 2),
                   (1, 7, 7, 256, 1, 1, 64, 1), (2, 12, 12, 512, 1, 1, 192, 1),
                   (1, 15, 17, 32, 3, 3, 128, 1), (2, 13, 13, 256, 3, 3, 192, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,kh,kw,cout,stride", CONV_TF32_CASES)
def test_tf32_conv2d_entry_matches_plain(cuda_device, n, h, w, cin, kh, kw, cout, stride):
    """fp32 through the 3xTF32 entry vs plain and the fp64 conv at the fp32
    band, an RMS error against fp64 at most 1.05 x the plain version's, and
    the same bits run to run and for every tile_h."""
    x, wt = _conv_inputs(n, h, w, cin, kh, kw, cout, stride, torch.float32, cuda_device)
    conv2d.COUNTER.reset()
    got = conv2d.conv2d_ntx(x, wt, stride=stride)
    again = conv2d.conv2d_ntx(x, wt, stride=stride)
    torch.cuda.synchronize()
    assert conv2d.COUNTER.entries == {conv_tf32.ENTRY: 2, conv_tf32.SPLIT: 2}
    assert conv2d.COUNTER.plain_calls == 0
    assert torch.equal(got, again)
    want = conv2d.conv2d_ntx_torch(x, wt, stride=stride)
    ref64 = conv2d_ref(x.double(), wt.double(), stride=stride)
    _conv_close(got, want)
    _conv_close(got, ref64.float())
    assert _rms_ratio(got, ref64, want) <= 1.05
    for tile_h in (1, 3, 100):
        assert torch.equal(got, conv2d.conv2d_ntx(x, wt, stride=stride, tile_h=tile_h))


@pytest.mark.cuda
def test_tf32_conv2d_entry_reads_padded_views(cuda_device):
    """A padded plane's interior (pixel strides of the full plane, base moved)
    gives the bits of its contiguous copy."""
    x, wt = _conv_inputs(2, 20, 20, 128, 3, 3, 192, 1, torch.float32, cuda_device)
    inner = x[:, 2:-2, 1:-1]
    assert not inner.is_contiguous()
    got = conv2d.conv2d_ntx(inner, wt)
    torch.cuda.synchronize()
    assert torch.equal(got, conv2d.conv2d_ntx(inner.contiguous(), wt))


@pytest.mark.cuda
def test_tf32_conv2d_entry_refuses_operands_it_cannot_read(cuda_device):
    x, wt = _conv_inputs(1, 12, 12, 64, 3, 3, 64, 1, torch.float32, cuda_device)
    wide = torch.zeros(1, 12, 12, 66, device=cuda_device)[..., :64]
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    conv2d.COUNTER.reset()
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        conv2d.conv2d_ntx(wide, wt)
    with pytest.raises(ValueError, match="unit channel stride"):
        conv2d.conv2d_ntx(nchw, wt)
    with pytest.raises(ValueError, match="takes fp32 with Cin a multiple of 32"):
        conv2d.launch(conv_tf32.ENTRY, x.bfloat16(), wt.bfloat16())
    assert conv2d.COUNTER.launches == 0


# the stem entry (Cin 3-style channel counts, kh*kw*Cin <= 256, Cout a
# multiple of 64; fp32 and bf16): L0's 7 x 7 x 3 at stride 2 on planes with
# ragged 8 x 16 pixel tiles, Cout 128, 3 x 3 and 1 x 1 stems, Cin 5
CONV_STEM_CASES = [(2, 45, 45, 3, 7, 7, 64, 2), (1, 38, 51, 3, 7, 7, 128, 2),
                   (2, 14, 19, 3, 3, 3, 64, 1), (1, 17, 15, 5, 3, 3, 64, 2),
                   (1, 9, 9, 3, 1, 1, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,kh,kw,cout,stride", CONV_STEM_CASES)
def test_stem_conv2d_entry_matches_plain_and_its_emulation(cuda_device, n, h, w, cin, kh, kw,
                                                           cout, stride, dtype):
    """Through the stem entry (by name: fp32 below conv2d.F32_TF32_MIN_K routes
    to FFMA) vs plain and the fp64 conv at the band of its dtype and vs its
    emulation; bf16 at most 1 % of y off the fp64 conv rounded once; at L0's
    7 x 7 x 3, fp32 RMS error against fp64 at most 1.05 x the plain version's
    (short sums read above it: the band holds them); the same bits run to run
    and for every tile_h."""
    x, wt = _conv_inputs(n, h, w, cin, kh, kw, cout, stride, dtype, cuda_device)
    short = dtype == torch.float32 and kh * kw * cin < conv2d.F32_TF32_MIN_K
    routed = conv2d.entry(dtype, cin, cout, kh, kw, stride)
    assert routed == (conv2d.FFMA if short else conv_stem.ENTRY)
    conv2d.COUNTER.reset()
    got = conv2d.launch(conv_stem.ENTRY, x, wt, stride=stride)
    again = conv2d.launch(conv_stem.ENTRY, x, wt, stride=stride)
    torch.cuda.synchronize()
    assert conv2d.COUNTER.entries == {conv_stem.ENTRY: 2}
    assert conv2d.COUNTER.plain_calls == 0
    assert torch.equal(got, again)
    want = conv2d.conv2d_ntx_torch(x, wt, stride=stride)
    ref64 = conv2d_ref(x.double(), wt.double(), stride=stride)
    _conv_close(got, want)
    _conv_close(got, ref64.to(dtype))
    _conv_close(got, conv_stem.emulate(x, wt, stride=stride))
    if dtype == torch.bfloat16:
        assert conv_rounded_once_share(got, x, wt, stride) <= 1e-2
    elif kh * kw * cin == 147:
        assert _rms_ratio(got, ref64, want) <= 1.05
    for tile_h in (1, 3, 100):
        assert torch.equal(got, conv2d.launch(conv_stem.ENTRY, x, wt, stride=stride,
                                              tile_h=tile_h))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stem_conv2d_entry_reads_any_strides(cuda_device, dtype):
    """NCHW data viewed as NHWC (chip_smoke.py's fp32 L0) and a padded plane's
    interior give the bits of their contiguous copies."""
    rng = np.random.RandomState(9)
    nchw = torch.as_tensor(rng.randn(2, 3, 47, 47), dtype=torch.float32).to(cuda_device, dtype)
    wt = torch.as_tensor(rng.randn(7, 7, 3, 64) * 0.2, dtype=torch.float32).to(cuda_device, dtype)
    x = nchw.permute(0, 2, 3, 1)
    inner = x[:, 1:-1, 2:-2]
    conv2d.COUNTER.reset()
    for view in (x, inner):
        assert not view.is_contiguous()
        got = conv2d.conv2d_ntx(view, wt, stride=2)
        assert torch.equal(got, conv2d.conv2d_ntx(view.contiguous(), wt, stride=2))
    torch.cuda.synchronize()
    assert conv2d.COUNTER.entries == {conv_stem.ENTRY: 4}


@pytest.mark.cuda
def test_stem_conv2d_entry_refuses_shapes_it_does_not_take(cuda_device):
    x, wt = _conv_inputs(1, 20, 20, 3, 7, 7, 64, 2, torch.float32, cuda_device)
    conv2d.COUNTER.reset()
    with pytest.raises(ValueError, match="kh\\*kw\\*Cin up to 256"):
        conv2d.launch(conv_stem.ENTRY, x, wt[..., :48], stride=2)  # Cout 48
    x64, w64 = _conv_inputs(1, 12, 12, 64, 3, 3, 64, 1, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="channel counts the wide kernels do not take"):
        conv2d.launch(conv_stem.ENTRY, x64, w64)  # the 3xTF32 kernel's channels
    with pytest.raises(ValueError, match="a slab that fits one block"):
        conv2d.launch(conv_stem.ENTRY, *_conv_inputs(1, 160, 160, 3, 7, 7, 64, 20,
                                                     torch.bfloat16, cuda_device), stride=20)
    assert conv2d.COUNTER.launches == 0


# (B, H, G, S, P, N, chunk) the fp32 tensor-core SSD entry takes: the Mamba-2
# 780M's P 64, N 128, chunk 128 (the one SSD_CASES shape it takes among
# them), G 2 at N 64 and chunk 64, P 128 with N 256, and G 4 with 8 heads
SSD_TF32_CASES = [
    (1, 2, 1, 128, 64, 128, 128),
    (2, 4, 2, 256, 64, 64, 64),
    (1, 2, 1, 256, 128, 256, 128),
    (1, 8, 4, 384, 64, 192, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("bs,h,g,s,p,n,chunk", SSD_TF32_CASES)
def test_ssd_tf32_entry_matches_plain_ref_and_emulation(cuda_device, bs, h, g, s, p, n, chunk):
    """fp32 through the 3xTF32 entry vs plain, ssd_ref and its emulation at
    3e-5 of max|y|, RMS error against the fp64 ssd_ref at most 1.05 x the
    plain version's, and the same bits run to run."""
    x, la, b, c = _ssd_inputs(bs, h, g, s, p, n, s + p + n, cuda_device)
    assert ssd_scan.entry(torch.float32, p, n, chunk) == ssd_scan_tf32.ENTRY
    ssd_scan.COUNTER.reset()
    got = ssd_scan.ssd_scan(x, la, b, c, chunk=chunk)
    again = ssd_scan.ssd_scan(x, la, b, c, chunk=chunk)
    want = ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk)
    ref64 = ssd_ref(x, la, b, c, compute_dtype=torch.float64)
    torch.cuda.synchronize()
    assert ssd_scan.COUNTER.entries == {ssd_scan_tf32.ENTRY: 2}
    assert torch.equal(got, again)
    assert _rel_err(got, want) <= SSD_TOL[torch.float32]
    assert _rel_err(got, ref64) <= SSD_TOL[torch.float32]
    assert _rel_err(got, ssd_scan_tf32.emulate(x, la, b, c, chunk=chunk)) <= SSD_TOL[torch.float32]
    assert _rms_ratio(got, ref64, want) <= 1.05


@pytest.mark.cuda
def test_ssd_tf32_strided_views_give_the_bits_of_contiguous_operands(cuda_device):
    x, la, b, c = _ssd_inputs(2, 8, 2, 256, 64, 128, 3, cuda_device)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (x, la, b, c)]
    assert not any(v.is_contiguous() for v in views)
    got = ssd_scan.ssd_scan(*views, chunk=128)
    want = ssd_scan.ssd_scan(x, la, b, c, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_ssd_tf32_strong_decay_and_dt_to_one(cuda_device):
    """la -4.8 per step (exp above the diagonal overflows) vs plain, and dt up
    to 1.0 (la to -48) vs the sequential ssd_ref: finite, within 3e-5."""
    bs, h, g, s, p, n = 1, 48, 1, 256, 64, 128
    x, _, b, c = _ssd_inputs(bs, h, g, s, p, n, 5, cuda_device)
    a = torch.arange(1, h + 1, dtype=torch.float32, device=cuda_device)
    strong = (-0.1 * a[None, :, None]).expand(bs, h, s).contiguous()
    dt = torch.as_tensor(np.random.RandomState(6).rand(bs, h, s), dtype=torch.float32,
                         device=cuda_device)
    ssd_scan.COUNTER.reset()
    got = ssd_scan.ssd_scan(x, strong, b, c, chunk=128)
    to_one = ssd_scan.ssd_scan(x, -dt * a[None, :, None], b, c, chunk=128)
    torch.cuda.synchronize()
    assert ssd_scan.COUNTER.entries == {ssd_scan_tf32.ENTRY: 2}
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(to_one).all())
    assert _rel_err(got, ssd_scan.ssd_scan_torch(x, strong, b, c, chunk=128)) <= 3e-5
    assert _rel_err(to_one, ssd_ref(x, -dt * a[None, :, None], b, c)) <= 3e-5


@pytest.mark.cuda
def test_ssd_tf32_refuses_operands_it_cannot_read(cuda_device):
    x, la, b, c = _ssd_inputs(1, 2, 1, 128, 64, 128, 2, cuda_device)
    odd = torch.zeros(1, 1, 128, 130, device=cuda_device)[..., :128]
    odd.copy_(b)  # rows of 520 bytes
    shifted = torch.zeros(x.numel() + 1, device=cuda_device)[1:].view(x.shape)
    shifted.copy_(x)
    ssd_scan.COUNTER.reset()
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ssd_scan.ssd_scan(x, la, odd, c)
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        ssd_scan.ssd_scan(shifted, la, b, c)
    with pytest.raises(ValueError, match="unit last stride"):
        ssd_scan.ssd_scan(x, la, b, c.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="takes fp32 with P and N multiples of 64"):
        ssd_scan.launch(ssd_scan_tf32.ENTRY, x.bfloat16(), la, b.bfloat16(), c.bfloat16())
    assert ssd_scan.COUNTER.launches == 0


# ROADMAP C5: fp32 sums too short for 3xTF32, routed to the FFMA entries
C5_CASES = [("conv", 3, 3), ("conv", 5, 3), ("conv", 32, 1), ("attention", 32, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,size,k", C5_CASES,
                         ids=["conv-K27", "conv-K45", "conv-1x1-cin32", "attention-window32"])
def test_short_fp32_sums_go_to_ffma_inside_the_rms_gate(cuda_device, kind, size, k):
    """The conv at K = kh*kw*Cin below conv2d.F32_TF32_MIN_K and attention with
    a window below flash_attention.F32_TF32_MIN_WINDOW launch the FFMA entry
    and read at most 1.05 x the plain version's RMS error against fp64; the
    1xTF32 control reads above it."""
    if kind == "conv":
        x, wt = _conv_inputs(4, 34, 34, size, k, k, 64, 1, torch.float32, cuda_device)
        assert k * k * size < conv2d.F32_TF32_MIN_K
        conv2d.COUNTER.reset()
        got = conv2d.conv2d_ntx(x, wt)
        torch.cuda.synchronize()
        assert conv2d.COUNTER.entries == {conv2d.FFMA: 1}
        want = conv2d.conv2d_ntx_torch(x, wt)
        ref64 = conv2d_ref(x.double(), wt.double())
        one = (conv_tf32 if size % 32 == 0 else conv_stem).emulate(x, wt, terms=1)
    else:
        q, kk, v = _attn_inputs(1, 8, 8, 1024, 1024, 64, 7, cuda_device)
        kw = {"causal": True, "window": size}
        assert size < flash_attention.F32_TF32_MIN_WINDOW
        flash_attention.COUNTER.reset()
        got = flash_attention.flash_attention(q, kk, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.COUNTER.entries == {"flash_attention_f32": 1}
        want = flash_attention.flash_attention_torch(q, kk, v, **kw)
        ref64 = attention_ref(q, kk, v, compute_dtype=torch.float64, **kw)
        one = attn_tf32.emulate(q, kk, v, terms=1, **kw)
    assert _rms_ratio(got, ref64, want) <= 1.05
    assert _rms_ratio(one, ref64, want) > 1.05


# ntx_exec: the NTX command kernel vs the plain interpreter
EXEC_ULPS = {"vexp": 2}  # CUDA's expf: at most 2 ulp; the plain exp is correctly rounded


def _exec_ulps(a, b) -> int:
    ia, ib = (t.cpu().view(torch.int32).long() for t in (a, b))
    return int((ia - ib).abs().max())


def _exec_command(rng, op, streaming: bool):
    from repro_torch.core.ntx import MAX_LOOPS, Agu, NtxCommand

    loops = tuple(int(x) for x in rng.randint(1, 4 if streaming else 5, MAX_LOOPS))
    dense = tuple(int(np.prod(loops[:j])) for j in range(MAX_LOOPS))

    def agu(base=None):
        return Agu(int(rng.randint(0, 60)) if base is None else base,
                   tuple(int(s) for s in rng.randint(-3, 4, MAX_LOOPS)))

    lvl = int(rng.randint(0, MAX_LOOPS + 1))
    two = op in ("mac", "vadd", "vmul", "cmpge")
    if streaming:  # dense unique writes away from the reads
        return NtxCommand(loops=loops, opcode=op, agu_rd0=Agu(0, dense),
                          agu_rd1=Agu(300, dense) if two else None, agu_wr=Agu(700, dense),
                          init_level=lvl, store_level=0, init_value=float(rng.randn()))
    # vexp writes away from its reads: exp of an exp read back would grow the
    # expf error past its bound
    return NtxCommand(loops=loops, opcode=op, agu_rd0=agu(), agu_rd1=agu() if two else None,
                      agu_wr=agu(200 + int(rng.randint(0, 60))) if op == "vexp" else agu(),
                      init_level=lvl,
                      store_level=lvl if op == "mac" else int(rng.randint(0, 3)),
                      init_value=float(rng.randn()))


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [True, False], ids=["wide", "narrow"])
@pytest.mark.parametrize("op", ["mac", "vadd", "vmul", "vmax", "vmin", "relu", "copy", "memset",
                                "argmax", "sign", "cmpge", "vexp", "vrecip", "vrsqrt"])
def test_ntx_exec_command_matches_plain(cuda_device, op, wide):
    """Random commands of one opcode, one launch each, against the plain
    interpreter on the same memory: the same bits (vexp within 2 ulp), in
    every mode the planning picks for them."""
    from repro_torch.core import ntx
    from repro_torch.kernels import ntx_exec

    rng = np.random.RandomState(sum(map(ord, op)) + wide)
    seen = set()
    ntx_exec.COUNTER.reset()
    for i in range(24):
        cmd = _exec_command(rng, op, streaming=i % 4 == 0)
        mem = np.abs(rng.randn(1024)).astype(np.float32) + 0.1
        mem[::3] *= -1 if op != "vrsqrt" else 1
        want = ntx.ntx_execute(cmd, torch.from_numpy(mem), wide)
        got = ntx.ntx_execute(cmd, torch.from_numpy(mem).to(cuda_device), wide)
        torch.cuda.synchronize()
        seen.add(ntx_exec.command_mode(cmd, mem.size))
        assert _exec_ulps(got, want) <= EXEC_ULPS.get(op, 0), repr(cmd)
    assert ntx_exec.COUNTER.launches == 24 and sum(ntx_exec.COUNTER.entries.values()) == 24
    assert ntx_exec.REGION in seen and ntx_exec.SEQUENTIAL in seen
    if op in ntx_exec._STREAM_OPS:
        assert ntx_exec.STREAMING in seen


@pytest.mark.cuda
def test_ntx_exec_training_step_matches_plain(cuda_device):
    """One training step of the paper CNN at batch 4 / img 16 through the
    command kernel (one launch per command, from one C call) against the
    plain interpreter: logits bit-identical, the rest within rtol 1e-5 /
    atol 1e-6 (vexp), the same bits run to run, 0 plain calls; the narrow
    accumulator is the narrow plain interpreter's bits too."""
    from repro_torch.kernels import ntx_exec
    from repro_torch.lower import lower_training_step, run_reference

    graph = paper_cnn_graph(batch=4, img=16)
    prog = lower_training_step(graph)
    x, labels = frequency_band_batches(np.random.RandomState(0), 4, 16)(0)
    inputs = {"x": x, "onehot": np.eye(10, dtype=np.float32)[labels], **graph.init_params(1)}
    want = run_reference(prog, inputs, device="cpu")
    ntx_exec.COUNTER.reset()
    got = run_reference(prog, inputs, device=cuda_device)
    again = run_reference(prog, inputs, device=cuda_device)
    torch.cuda.synchronize()
    per_mode = ntx_exec.program_table(prog)["per_mode"]
    assert ntx_exec.COUNTER.launches == 2 * prog.n_commands
    assert ntx_exec.COUNTER.entries == {m: 2 * n for m, n in per_mode.items() if n}
    assert ntx_exec.COUNTER.plain_calls == 0
    assert torch.equal(got[graph.logits_edge].cpu(), want[graph.logits_edge])
    for k, v in want.items():
        assert torch.equal(got[k], again[k]), k
        torch.testing.assert_close(got[k].cpu(), v, rtol=1e-5, atol=1e-6, msg=k)
    narrow = run_reference(prog, inputs, wide=False, device=cuda_device)
    narrow_plain = run_reference(prog, inputs, wide=False, device="cpu")
    assert torch.equal(narrow[graph.logits_edge].cpu(), narrow_plain[graph.logits_edge])


@pytest.mark.cuda
def test_ntx_exec_templates_match_the_kernels(cuda_device):
    """The matmul and conv templates on the command kernel against B5's and
    B6's kernels on the card: one contraction, two designs."""
    from repro_torch.core import ntx
    from repro_torch.lower.rules import conv2d_fwd_template, matmul_template

    m, n, k = 64, 48, 96
    a, b = _mm_inputs(m, n, k, torch.float32, cuda_device)
    mem = torch.zeros(20_000, device=cuda_device)
    mem[: m * k] = a.reshape(-1)
    mem[8_000: 8_000 + k * n] = b.reshape(-1)
    ntx.ntx_execute(matmul_template(m, n, k, 0, 8_000, 14_000), mem, inplace=True)
    got = mem[14_000: 14_000 + m * n].reshape(m, n)
    torch.testing.assert_close(got, ops.matmul(a, b), rtol=1e-5, atol=1e-5)
    x, wt = _conv_inputs(1, 18, 18, 32, 3, 3, 64, 1, torch.float32, cuda_device)
    cmem = torch.zeros(60_000, device=cuda_device)
    cmem[: x.numel()] = x.reshape(-1)
    cmem[20_000: 20_000 + wt.numel()] = wt.reshape(-1)
    for co in range(64):  # one command per output channel
        ntx.ntx_execute(conv2d_fwd_template(18, 18, 32, 3, 3, 64, 0, 20_000 + co, 40_000 + co),
                        cmem, inplace=True)
    y = cmem[40_000: 40_000 + 16 * 16 * 64].reshape(1, 16, 16, 64)
    torch.testing.assert_close(y, conv2d.conv2d_ntx(x, wt), rtol=1e-4, atol=1e-4)
