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
from repro_torch.kernels import flash_attention_wgmma as wgmma
from repro_torch.kernels.ref import (attention_ref, conv2d_ref, matmul_ref64, rounded_once_share,
                                     ssd_ref)
from repro_torch.lower import (
    MaxPool2dSpec,
    RegionSpec,
    Stage,
    frequency_band_batches,
    paper_cnn_graph,
    plan_fusion,
    run_torch,
)

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
    assert (flash_attention.COUNTER.launches, flash_attention.COUNTER.plain_calls) == (2, 1)
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
    """fp32 on the FFMA entry at every head dim; bf16 on the tensor-core entry
    at D 64 and 128 and on the FFMA bf16 entry at D 32 and 256."""
    flash_attention.COUNTER.reset()
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 32), (torch.bfloat16, 64),
                     (torch.bfloat16, 128), (torch.bfloat16, 256)):
        flash_attention.flash_attention(*_attn_inputs(1, 2, 1, 128, 128, d, 1, cuda_device, dtype))
    torch.cuda.synchronize()
    assert flash_attention.COUNTER.entries == {
        "flash_attention_f32": 1, "flash_attention_bf16": 2, wgmma.ENTRY: 2}
    assert flash_attention.COUNTER.launches == 5


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
