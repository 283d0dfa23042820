#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version at the shapes of the
main path, drives the main paths and checks that each went through its kernels:

* ``repro_torch.launch.train.run_ntx_cnn`` on the paper CNN at batch 64,
  img 32, fused and then ``--no-fuse`` (the fused-region kernel on its
  shared-memory entry, a thread-block cluster per image, with the arena
  entry checked and timed beside it; and ``streaming_matmul`` on the
  tensor-core GEMM of K-tile partials);
* ``repro_torch.lower.train_graph(backend="reference")`` on the same CNN
  step lowered to one NtxProgram (``lower_training_step``: 11,606
  commands), every command one launch of the command kernel ``ntx_exec``,
  held against the plain interpreter (logits bit-identical) and the fused
  step; the matmul and conv command templates against B2, B5 and B6;
* the obs layer and the NTX timing model on that step: ``run_ntx_cnn`` with
  ``metrics=`` and ``trace=`` (losses bit-identical to the plain run, one
  region launch a step, the JSONL's counters equal to the program's closed
  form and the fusion plan, the trace's lowering, dispatch and ``hmc0``
  lanes), ``run_timing`` of the step program on both engines against the
  JAX package's figures, one reference step under a registry;
* ``repro_torch.models.lm.prefill`` of Mamba-2 780M at full width and
  depth (48 layers, d_model 1536, vocab 50,288) on 2 x 2,048 tokens, in
  bf16 and in fp32 (the SSD-scan kernels, 48 launches per prefill, both on
  the tensor cores: bf16 on the bf16 kernel, fp32 on the 3xTF32 kernel);
* ``repro_torch.models.lm.prefill`` of Qwen1.5-0.5B at full width and
  depth (24 attention + MLP layers, d_model 1024, 16 heads of 64, vocab
  151,936) on 2 x 2,048 tokens, in bf16 and in fp32 (the flash-attention
  kernels, 24 calls per prefill: bf16 on the tensor-core kernel,
  fp32 on the 3xTF32 tensor-core kernel, the first 96 query rows of each
  call on the FFMA kernel);
* the NTX kernel API at the paper's GoogLeNet layer widths, batch 32:
  ``repro_torch.kernels.ops.matmul`` (plain and compensated, fp32 and bf16)
  on the four layers' im2col products and on 1024^3 (the same tensor-core
  GEMM: bf16 as it is, fp32 as 3xTF32), then
  ``repro_torch.kernels.conv2d_ntx`` on the four layers in fp32 and in bf16
  (the direct-convolution kernels, all on the tensor cores: L1-L3 on the
  wide kernels, bf16 as it is and fp32 as 3xTF32, L0's Cin 3 stem on the
  stem kernel in both dtypes);
* the fp32 sums too short for 3xTF32 (conv K 27, K 45, 1 x 1 x 32;
  attention with a window of 32), routed to the FFMA kernels and held by
  the RMS gate against fp64 with the 1xTF32 control.

The last lines are the card's name and power limit, one
``{"kernels": [...]}`` JSON line, and ``{"ok": true, "device": {...}}``.
Any failed phase makes it exit 1 without that last line; with no CUDA
device it exits 2.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks: HBM3 bandwidth; per operand type, fp32 outside
# the tensor cores, tf32 and bf16 (dense) on them. fp32 products on the
# tensor-core GEMM (streaming_matmul, ntx_matmul) are three tf32 products
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
TOL = {"rtol": 1e-5, "atol": 1e-6}
BATCH, IMG, STEPS = 64, 32, 5
# Mamba-2 780M prefill: batch x tokens, ids below the unpadded vocab 50,280
PREFILL_BATCH, PREFILL_SEQ, TOKEN_HIGH = 2, 2048, 50_280
# SSD gates, relative to max|y|: the band of the JAX kernel sweep (fp32);
# bf16 y rounds once, one bf16 ulp of max|y| being 2**-8 ~ 3.9e-3
SSD_TOL = {"float32": 3e-5, "bfloat16": 1e-2}
# prefill gate, relative to max|logits|: fp32 kernel vs plain SSD
PREFILL_TOL = {"float32": 1e-4}
# one bf16 ssm_block, kernel vs plain SSD, relative to max|out|: the two
# differ by one rounding of y, carried through the gate, norm and w_out
BLOCK_TOL = 1e-2
# flash-attention gates: fp32 elementwise |got - want| <= atol + rtol |want|
# (the band of tests/kernels/test_flash_attention.py, inputs of 0.3 std);
# bf16 max|got - want| <= 1e-2 max|want| (o rounds once: at most 2**-8 of it)
ATTN_F32 = {"atol": 2e-5, "rtol": 1e-3}
ATTN_BF16 = 1e-2
# rounded-once gate (bf16): at most this share of o's elements may differ from
# the fp64 attention of the same operands rounded once to bf16. p in fp32
# moves about 0.02 %, p as two bf16 terms about 0.2 %, p as one bf16 term
# about 38 % (the CPU emulation of tests/test_torch_attention_wgmma.py)
ROUNDED_ONCE = 1e-2
# fp32 attention and conv on the 3xTF32 tensor-core kernels are also held by
# ntx_matmul's RMS gate (MM_RMS): RMS error against the fp64 result at most
# 1.05 x the plain version's. Attention reads it at every case on that entry;
# the 1xTF32 product (hi.hi alone), q and k rounded to bf16, and p rounded to
# bf16 must fail it. The conv reads it at every layer the tensor-core kernel
# takes. hi + lo keep about 22 of fp32's 24 significand bits and lo.lo is
# dropped, so every 3xTF32 product is off by up to about 2**-21 of itself
# where the plain version's fp32 product is off by 2**-24; long sums hide
# that under their own rounding, sums of a few dozen terms do not. So fp32
# convs with K below conv2d.F32_TF32_MIN_K and attention with a window below
# flash_attention.F32_TF32_MIN_WINDOW go to the FFMA entries (check_c5), and
# so do the first 96 rows of a long causal call (flash_attention.ffma_rows).
# Qwen1.5-0.5B prefill: batch x tokens, ids below the vocab 151,936
QWEN_BATCH, QWEN_SEQ, QWEN_TOKEN_HIGH = 2, 2048, 151_936
# the paper's GoogLeNet conv layers (Tables 2-4; CONV_LAYERS["googlenet"] of
# benchmarks/workloads.py) at batch 32: (label, H, W, Cin, k, stride, pad, Cout)
GOOGLENET = (
    ("L0", 224, 224, 3, 7, 2, 3, 64),
    ("L1", 56, 56, 64, 3, 1, 1, 192),
    ("L2", 28, 28, 256, 1, 1, 0, 64),
    ("L3", 14, 14, 512, 1, 1, 0, 192),
)
NTX_BATCH = 32
# ntx_matmul gates on randn operands: |kernel - plain| <= atol sqrt(K) + rtol |plain|
# (the band of tests/kernels/test_ntx_matmul.py); RMS error against the fp64
# product at most MM_RMS x the plain version's
MM_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
MM_RTOL = 1e-2
MM_RMS = 1.05
# compensation gate: integers below 256 (exact in bf16 too) over Table 1's
# reduction length K = 3*3*192, so each K tile of 128 sums exactly in fp32
# (< 2**23) and the total (~2.8e7) crosses 2**24
COMP_SHAPE, COMP_HIGH = (1024, 1728, 192), 256
# conv2d_ntx gates: fp32 elementwise atol + rtol |want| (the band of
# tests/kernels/test_conv2d.py: x randn, w 0.2 randn); bf16 max|y - want|
# <= 1e-2 max|want| (y rounds once: at most 2**-9 of it)
CONV_F32 = {"atol": 1e-4, "rtol": 1e-4}
CONV_BF16 = 1e-2
# bf16 conv2d_ntx is also held by the rounded-once gate: at most ROUNDED_ONCE
# of y's elements may differ from the fp64 conv rounded once to bf16 (fp32
# sums move a few in ten thousand; the conv that rounds its sum to bf16 after
# every stage of 64 channels of a tap moves 40-75 %, tests/test_torch_conv2d_wgmma.py)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int = 10) -> dict[str, float]:
    """Device time of ``fn`` per call in ms, by kernel name, under
    torch.profiler over ``iters`` warm calls; empty where the profiler sees
    no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def device_ms(fn, iters: int = 10) -> float:
    """Device time of ``fn`` per call in ms: the kernels' own time under
    torch.profiler over ``iters`` warm calls. CUDA events around back-to-back
    calls also count the host's enqueue where it is longer than the device's
    work; this leaves it out. NaN where the profiler sees no device time."""
    total = sum(kernel_ms(fn, iters).values())
    return total if total > 0 else float("nan")


def bound_ms(nbytes: float, flops: float, dtype: str = "float32") -> tuple[float, str]:
    """Least time for the work on the card, and which side bounds it: the
    bytes over the HBM rate, the FLOPs over the peak rate of the operands' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


class Smoke:
    def __init__(self):
        self.failures: list[str] = []
        self.kernels: dict[str, dict] = {}

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # recorded; the run exits 1 at the end
            self.failures.append(name)
            traceback.print_exc()
            print(f"== {name}: FAILED", flush=True)
            return None
        print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        return out


def device_info():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")
    return name, smi


def build_kernels():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"built {len(paths)} kernel libraries in {time.perf_counter() - t0:.1f} s "
          f"into {build.BUILD_DIR}")
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")
    # the tensor-core kernels must run on wgmma (HGMMA) and TMA (UTMALDG); the
    # convs' gathers on cp.async (LDGSTS); the fp32 attention loads through
    # registers (it splits every element on the way into shared memory)
    for name, ops in (("flash_attention_wgmma", ("HGMMA", "UTMALDG")),
                      ("flash_attention_tf32", ("HGMMA",)),
                      ("conv2d_ntx_wgmma", ("HGMMA", "UTMALDG", "LDGSTS")),
                      ("conv2d_ntx_tf32", ("HGMMA", "UTMALDG", "LDGSTS")),
                      ("ntx_gemm_wgmma", ("HGMMA",)),
                      ("ssd_scan_wgmma", ("HGMMA", "UTMALDG")),
                      ("ssd_scan_tf32", ("HGMMA",)),
                      ("conv2d_ntx_stem", ("HGMMA",))):
        sass = subprocess.run([str(Path(build.nvcc_path()).parent / "cuobjdump"), "-sass",
                               str(paths[name])],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        counts = {op: sass.count(op) for op in ops}
        print(f"  {name} SASS: {counts}")
        assert all(counts.values()), f"{name} lacks an instruction it is built on: {counts}"
    # the fp32 attention moves registers between warpgroups by setmaxnreg; with
    # fewer registers than its split takes the block would wait forever
    from repro_torch.kernels import flash_attention_tf32 as attn_tf32

    for d in attn_tf32.HEAD_DIMS:
        regs, needed = attn_tf32.kernel_registers(d)
        print(f"  flash_attention_tf32 D {d}: built with {regs} registers a thread; its "
              f"setmaxnreg split needs {needed}")
        assert needed == attn_tf32.registers_needed(d) and regs >= needed, (d, regs, needed)


def ptxas_summary(name: str) -> str:
    """The most registers, static shared bytes and spill bytes ptxas reports
    over a library's kernels."""
    import re

    from repro_torch.kernels import build

    log = build.BUILD_LOGS.get(name, "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    smem = [int(b) for b in re.findall(r"(\d+) bytes smem", log)]
    spills = [int(a) + int(b) for a, b in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    if not regs:
        return f"{name}: no ptxas report (built before this run)"
    return (f"{name}: at most {max(regs)} registers, {max(smem, default=0)} bytes of static "
            f"shared memory, {max(spills, default=0)} bytes spilled")


def main_path_graph_inputs(device):
    import numpy as np
    import torch

    from repro_torch.convert import params_from_jax
    from repro_torch.lower import frequency_band_batches, paper_cnn_graph

    graph = paper_cnn_graph(batch=BATCH, img=IMG)
    x, labels = frequency_band_batches(np.random.RandomState(0), BATCH, IMG)(0)
    inputs = {
        "x": torch.as_tensor(x, device=device),
        "onehot": torch.as_tensor(np.eye(10, dtype=np.float32)[labels], device=device),
        **params_from_jax(graph.init_params(seed=0), graph, device),
    }
    return graph, inputs


def check_streaming(smoke: Smoke, device):
    """streaming_matmul vs its plain version on the operands of one unfused step.

    Every call goes to the tensor-core GEMM of K-tile partials
    (``csrc/ntx_gemm_wgmma.cu``, 3xTF32) at the split the wrapper plans. Per
    call: the kernel vs the plain version at 1e-5 of |A|.|B|; where the call
    splits, split 1 gives the same bits; the FFMA entry (``csrc/streaming_mm.cu``,
    called by name) is timed beside it. The 1xTF32 control (hi.hi alone,
    ``gemm_wgmma.emulate``) is read through the same gate. Bound: each input
    read and each output written once, or the three tf32 products at the tf32
    rate; the fp32-FFMA bound is printed beside it.
    """
    import torch

    from repro_torch.kernels import gemm_wgmma as gemm
    from repro_torch.kernels import streaming
    from repro_torch.lower import run_torch

    graph, inputs = main_path_graph_inputs(device)
    calls = []
    orig = streaming.streaming_matmul

    def recorder(a, b):
        calls.append((a, b))
        return orig(a, b)

    streaming.streaming_matmul = recorder  # executors and conv2d look it up at call time
    try:
        run_torch(graph, inputs, fuse=False, device=device)
    finally:
        streaming.streaming_matmul = orig
    torch.cuda.synchronize()

    g = torch.Generator(device="cpu").manual_seed(0)
    extra = [
        ("ragged", torch.randn(100, 333, generator=g), torch.randn(333, 70, generator=g)),
        ("a.T view", torch.randn(257, 130, generator=g).T, torch.randn(257, 33, generator=g)),
        ("b.T view", torch.randn(77, 200, generator=g), torch.randn(45, 200, generator=g).T),
    ]
    sms = gemm.sm_count(device.index or 0)
    worst_rel, worst_abs, ctl_min, ctl_max, joins = 0.0, 0.0, math.inf, 0.0, 0
    tot = {k: 0.0 for k in ("ms", "ffma_ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_ffma_ms", "bytes", "flops")}
    print(f"{'call':>28} {'M':>6} {'N':>5} {'K':>6} {'split':>5} {'err/|A||B|':>10} "
          f"{'1xTF32':>8} {'ms':>8} {'ffma':>8} {'plain':>8} {'lib':>8} {'bound':>8}")
    for i, (a, b) in enumerate(calls):
        m, k = a.shape
        n = b.shape[1]
        split = gemm.plan_split(m, n, k, streaming._block(k), sms)
        got = streaming.streaming_matmul(a, b)
        want = streaming.streaming_matmul_torch(a, b)
        scale = torch.matmul(a.abs(), b.abs()) + 1e-30
        rel = float(((got - want).abs() / scale).max())
        ctl = gemm.emulate(a, b, block_k=streaming._block(k), terms=1)
        rel_ctl = float(((ctl - want).abs() / scale).max())
        ctl_min, ctl_max = min(ctl_min, rel_ctl), max(ctl_max, rel_ctl)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, max_abs(got, want))
        if split > 1:
            assert torch.equal(got, streaming.launch(gemm.ENTRY, a, b, split=1)), \
                f"call {i}: split {split} and split 1 gave different bits"
        joins += gemm.workspace_numel(m, n, k, streaming._block(k), split) > 0
        ms = time_ms(lambda: streaming.streaming_matmul(a, b))
        ffma = time_ms(lambda: streaming.launch(streaming.FFMA, a, b))
        plain = time_ms(lambda: streaming.streaming_matmul_torch(a, b))
        lib = time_ms(lambda: torch.matmul(a, b))
        nbytes, flops = 4.0 * (m * k + k * n + m * n), 2.0 * m * n * k
        bnd, _ = bound_ms(nbytes, 3 * flops, "tf32")
        for key, v in (("ms", ms), ("ffma_ms", ffma), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bnd), ("bound_ffma_ms", bound_ms(nbytes, flops)[0]),
                       ("bytes", nbytes), ("flops", flops)):
            tot[key] += v
        view = "a.T" if a.stride(0) == 1 and m > 1 else ("b.T" if b.stride(0) == 1 and k > 1 else "")
        print(f"{f'step call {i} {view}':>28} {m:>6} {n:>5} {k:>6} {split:>5} {rel:>10.2e} "
              f"{rel_ctl:>8.2e} {ms:>8.4f} {ffma:>8.4f} {plain:>8.4f} {lib:>8.4f} {bnd:>8.5f}")
        if rel > 1e-5:
            raise AssertionError(f"call {i} ({m}x{k} @ {k}x{n}): error {rel:.2e} of |A||B|")
    for label, a, b in extra:
        a, b = a.to(device), b.to(device)
        got = streaming.streaming_matmul(a, b)
        want = streaming.streaming_matmul_torch(a, b)
        err = max_abs(got, want)
        print(f"{label:>28} {a.shape[0]:>6} {b.shape[1]:>5} {a.shape[1]:>6} max_abs {err:.2e}")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    _, by = bound_ms(tot["bytes"], 3 * tot["flops"], "tf32")
    per_kernel = kernel_ms(lambda: [streaming.streaming_matmul(a, b) for a, b in calls])
    dev = {part: sum(v for key, v in per_kernel.items() if f"{part}_kernel" in key)
           for part in ("gemm", "join")}
    print(f"one unfused step: {len(calls)} streaming_matmul calls ({joins} of them split: "
          f"{len(calls)} GEMM and {joins} join launches), device time GEMM {dev['gemm']:.4f} ms, "
          f"join {dev['join']:.4f} ms (torch.profiler); kernel "
          f"{tot['ms']:.4f} ms, FFMA entry {tot['ffma_ms']:.4f} ms, plain {tot['plain_ms']:.4f} "
          f"ms, torch.matmul {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms "
          f"({tot['bytes']/1e6:.2f} MB, 3 x {tot['flops']/1e6:.1f} MFLOP at the tf32 rate; "
          f"{tot['bound_ffma_ms']:.5f} ms at the fp32-FFMA rate); worst error "
          f"{worst_rel:.2e} of |A||B|, {worst_abs:.2e} absolute; "
          f"{ptxas_summary(gemm.LIB)}")
    print(f"  1xTF32 control through the 1e-5 gate: {ctl_min:.2e} .. {ctl_max:.2e} of |A||B| "
          f"over the calls ({'rejected' if ctl_max > 1e-5 else 'passes'})")
    assert ctl_max > 1e-5, "the streaming gate let the 1xTF32 control through"
    smoke.kernels["streaming_matmul"] = {
        "name": "streaming_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ntx_gemm_wgmma.cu",
        "replaces": "src/repro/kernels/streaming.py:96",
        "launches": None,
        "max_abs_err": worst_abs,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": by,
        "library_ms": tot["library_ms"],
        "calls_per_step": len(calls),
        "joins_per_step": joins,
        "join_launches": None,
        "device_ms": dev["gemm"],
        "join_device_ms": dev["join"],
        "ffma_source": "src/repro_torch/kernels/csrc/streaming_mm.cu",
        "ffma_ms": tot["ffma_ms"],
    }


def _conv_valid_taps(n_out, k, s, p, n_in):
    return sum(1 for o in range(n_out) for d in range(k) if 0 <= o * s - p + d < n_in)


def region_work(region, inputs, outputs) -> tuple[float, float]:
    """Bytes (inputs read once, outputs written once) and FLOPs of a region."""
    import math

    from repro_torch.lower import (BiasSpec, Conv2dSpec, MatmulSpec, MaxPool2dSpec,
                                   ReluSpec, SoftmaxXentSpec)

    nbytes = 4.0 * (sum(t.numel() for t in inputs.values())
                    + sum(t.numel() for t in outputs.values()))
    B, flops = region.batch, 0.0
    for st in region.stages:
        s = st.spec
        if st.pass_ == "upd":  # v_new = mu*v + dw, w_new = w - lr*v_new
            flops += 4.0 * math.prod(inputs[st.param].shape)
        elif isinstance(s, Conv2dSpec):  # fwd, dW and dX touch the same valid taps
            taps = (_conv_valid_taps(s.out_h, s.kh, s.stride, s.padding, s.in_h)
                    * _conv_valid_taps(s.out_w, s.kw, s.stride, s.padding, s.in_w))
            flops += 2.0 * B * taps * s.cin * s.cout
        elif isinstance(s, MatmulSpec):
            flops += 2.0 * B * s.k * s.n
        elif isinstance(s, MaxPool2dSpec):  # max; dX also compares with it
            flops += B * s.in_h * s.in_w * s.c * (1 if st.pass_ == "fwd" else 2)
        elif isinstance(s, ReluSpec):
            flops += B * math.prod(s.shape)
        elif isinstance(s, BiasSpec) and st.pass_ != "dx":
            flops += s.rows * s.c
        elif isinstance(s, SoftmaxXentSpec):  # max, exp, sum, divide, subtract
            flops += 5.0 * B * s.classes
    return nbytes, flops


def library_step(graph, ins):
    """The same train step in eager PyTorch with cuDNN convolutions and
    autograd: the yardstick for the fused region (never used by the port)."""
    import torch
    import torch.nn.functional as F

    names = list(graph.param_shapes())
    ps = [ins[p].detach().requires_grad_() for p in names]
    w_c1, w_c2, w_fc, b_fcb = ps
    h = F.conv2d(ins["x"].permute(0, 3, 1, 2), w_c1.permute(3, 2, 0, 1), stride=2, padding=2)
    h = F.conv2d(F.relu(h), w_c2.permute(3, 2, 0, 1), stride=2, padding=1)
    h = F.max_pool2d(F.relu(h), 2)
    z = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1) @ w_fc + b_fcb
    loss = -(F.log_softmax(z, dim=-1) * ins["onehot"]).sum(dim=-1).mean()
    grads = torch.autograd.grad(loss, ps)
    outs = {graph.logits_edge: z.detach()}
    with torch.no_grad():
        for p, w, gr in zip(names, ps, grads):
            v_new = graph.momentum * ins[f"v_{p}"] + gr
            outs[f"d_{p}"] = gr
            outs[f"v_{p}_new"] = v_new
            outs[f"{p}_new"] = w - graph.lr * v_new
    return outs


def check_region(smoke: Smoke, device):
    """The fused-region kernel vs region_torch on the full-width region: the
    shared-memory entry (a cluster per image) that the region routes to,
    forced cluster sizes, and the arena entry beside it."""
    import re

    import torch

    from repro_torch.kernels import fused
    from repro_torch.lower import MaxPool2dSpec, RegionSpec, Stage, plan_fusion

    graph, inputs = main_path_graph_inputs(device)
    plan = plan_fusion(graph)
    assert plan.n_regions == 1 and not plan.fallback_steps, plan.fallback_steps
    region = plan.segments[0].region
    ins = {n: inputs[n] for n, _ in region.inputs}
    run = fused.build_region_callable(region, device=device)
    fused.COUNTER.reset()
    got = run(ins)
    want = fused.region_torch(region, ins)
    torch.cuda.synchronize()
    kern = fused.region_kernel(region, ins, device)
    c = kern.compiled
    assert fused.COUNTER.entries == {fused.SMEM: 1}, fused.COUNTER.entries
    staged = sum(b.numel for b in c.buffers if b.mode & fused.STAGED)
    print(f"  {region.label}: {fused.SMEM}, cluster {kern.cluster} CTAs an image "
          f"({BATCH * kern.cluster} CTAs; clusters the card runs at once by size "
          f"{fused.active_clusters(4 * c.smem, device)}), {4 * c.smem} + {fused.SMEM_STATIC} "
          f"bytes of shared memory a CTA ({staged} floats staged); "
          f"{ptxas_summary('fused_region')}")
    worst = 0.0
    for k, v in want.items():
        err = max_abs(got[k], v)
        worst = max(worst, err)
        print(f"  {k:>12} {tuple(v.shape)!s:>16} max_abs {err:.3e}")
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, **TOL, msg=f"fused region output {k}")
    # bits: run == run and the same at every forced cluster size; the arena
    # entry is held against plain too
    for cl in (1, 2, 4, 8):
        again = kern(ins, cluster=cl)
        assert all(torch.equal(again[k], got[k]) for k in got), f"cluster {cl} changed the bits"
    arena = kern(ins, name=fused.ARENA)
    for k, v in want.items():
        torch.testing.assert_close(arena[k], v, **TOL, msg=f"arena entry output {k}")
    torch.cuda.synchronize()
    print(f"  clusters of 1, 2, 4 and 8 CTAs: the same bits as the routed run; the arena entry "
          f"within rtol {TOL['rtol']} / atol {TOL['atol']}, max_abs "
          f"{max(max_abs(arena[k], v) for k, v in want.items()):.3e}")
    lib = library_step(graph, ins)
    for k, v in want.items():
        torch.testing.assert_close(lib[k], v, rtol=1e-3, atol=1e-5,
                                   msg=f"eager-torch step output {k}")
    print(f"  eager-torch (cuDNN + autograd) step agrees within rtol 1e-3 / atol 1e-5; "
          f"max_abs {max(max_abs(lib[k], v) for k, v in want.items()):.3e}")

    # max-pool ties, exact, on both entries: the all-ties window case and
    # plateaued activations at the main path's pool width
    g = torch.Generator(device="cpu").manual_seed(1)
    for spec, b, x in (
        (MaxPool2dSpec(4, 4, 2), 2, torch.ones(2, 4, 4, 2)),
        (MaxPool2dSpec(8, 8, 32), BATCH, torch.randint(0, 3, (BATCH, 8, 8, 32), generator=g).float()),
    ):
        st = Stage(node="p1", pass_="dx", spec=spec, in_edge="x", out_edge="a_p1")
        pool = RegionSpec(stages=(st,), batch=b, lr=0.05, momentum=0.0,
                          inputs=(("x", True), ("d_a_p1", True)),
                          outputs=(("d_x", "batched"),))
        gy = torch.randn(b, spec.out_h, spec.out_w, spec.c, generator=g)
        pins = {"x": x.to(device), "d_a_p1": gy.to(device)}
        pp = fused.region_torch(pool, pins)["d_x"]
        pk = fused.region_kernel(pool, pins, device)
        assert pk.entry == fused.SMEM, pk.entry
        for name in (fused.SMEM, fused.ARENA):
            torch.testing.assert_close(pk(pins, name=name)["d_x"], pp, rtol=0, atol=0,
                                       msg=f"maxpool ties {spec} on {name}")
        print(f"  maxpool ties {spec.in_h}x{spec.in_w}x{spec.c} batch {b}: exact on both entries")

    # the old entry beside the new one, A B B A, by events and by device time
    def arena_run():
        return kern(ins, name=fused.ARENA)

    def smem_run():
        return run(ins)

    times = [time_ms(f) for f in (arena_run, smem_run, smem_run, arena_run)]
    ms, arena_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
    dev_ms, arena_dev = device_ms(smem_run), device_ms(arena_run)
    by_kernel = kernel_ms(smem_run)
    plain = time_ms(lambda: fused.region_torch(region, ins))
    lib_ms = time_ms(lambda: library_step(graph, ins))
    lib_dev = device_ms(lambda: library_step(graph, ins))
    nbytes, flops = region_work(region, ins, want)
    bnd, by = bound_ms(nbytes, flops)
    print(f"fused region {region.label} at batch {BATCH}, img {IMG}: {fused.SMEM} "
          f"{ms:.4f} ms by events, {dev_ms:.4f} ms device; {fused.ARENA} {arena_ms:.4f} ms by "
          f"events, {arena_dev:.4f} ms device (A B B A events: "
          f"{', '.join(f'{t:.4f}' for t in times)}); plain {plain:.4f} ms; eager torch "
          f"{lib_ms:.4f} ms by events, {lib_dev:.4f} ms device; bound {bnd:.5f} ms "
          f"({nbytes/1e6:.3f} MB, {flops/1e6:.1f} MFLOP, {by})")
    print("  device time by kernel: " + ", ".join(
        f"{re.search(r'(\w+)\(', k).group(1)} {v:.4f} ms" for k, v in by_kernel.items()))
    assert dev_ms < arena_dev, f"the shared-memory entry ({dev_ms:.4f} ms) is not faster"
    smoke.kernels["fused_region"] = {
        "name": "fused_region",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_region.cu",
        "replaces": "src/repro/kernels/fused.py:262",
        "launches": None,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": lib_ms,
        "entry": fused.SMEM,
        "device_ms": dev_ms,
        "arena_ms": arena_ms,
        "arena_device_ms": arena_dev,
        "library_device_ms": lib_dev,
    }


def main_path(smoke: Smoke, device):
    """run_ntx_cnn fused, then --no-fuse; every kernel must be launched."""
    import torch

    from repro_torch.kernels import fused, streaming
    from repro_torch.kernels import gemm_wgmma as gemm
    from repro_torch.launch.train import run_ntx_cnn

    counters = (fused.COUNTER, streaming.COUNTER)
    runs = {}
    for fuse in (True, False):
        for c in counters:
            c.reset()
        res = run_ntx_cnn(STEPS, BATCH, IMG, fuse=fuse, device=device)
        counts = {c.name: (c.launches, c.plain_calls) for c in counters}
        print(f"  fuse={fuse}: launches / plain calls {counts}, by C entry: fused_region "
              f"{fused.COUNTER.entries}, streaming_matmul {streaming.COUNTER.entries}")
        runs[fuse] = (res, counts, dict(streaming.COUNTER.entries))
        if fuse:  # every fused step on the shared-memory entry, none on the arena entry
            assert fused.COUNTER.entries == {fused.SMEM: STEPS}, fused.COUNTER.entries
    launches = {"fused_region": runs[True][1]["fused_region"][0],
                "streaming_matmul": runs[False][1]["streaming_matmul"][0]}
    for name, k in smoke.kernels.items():
        k["launches"] = launches[name]
    sm = smoke.kernels["streaming_matmul"]
    sm["join_launches"] = runs[False][2].get(gemm.JOIN, 0)
    for fuse, (res, counts, _) in runs.items():
        losses = res["losses"]
        assert losses[-1] < losses[0], f"fuse={fuse}: loss did not decrease {losses}"
        assert all(plain == 0 for _, plain in counts.values()), counts
        for k, v in res["first_outputs"].items():
            assert torch.isfinite(v).all(), f"fuse={fuse}: {k} not finite"
    assert launches["fused_region"] > 0, "the fused run launched no region kernel"
    assert launches["streaming_matmul"] > 0, "the unfused run launched no streaming_matmul"
    want_entries = {gemm.ENTRY: launches["streaming_matmul"],
                    gemm.JOIN: STEPS * sm["joins_per_step"]}
    assert runs[False][2] == want_entries, (runs[False][2], want_entries)
    f0, u0 = runs[True][0]["first_outputs"], runs[False][0]["first_outputs"]
    assert set(f0) == set(u0)
    for k in f0:
        torch.testing.assert_close(f0[k], u0[k], **TOL, msg=f"step 0 fused vs unfused {k}")
    print(f"  step-0 outputs fused == unfused within rtol {TOL['rtol']} / atol "
          f"{TOL['atol']}; max_abs {max(max_abs(f0[k], u0[k]) for k in f0):.3e}")
    for fuse, (res, *_) in runs.items():
        walls = res["walls"][1:]
        print(f"  fuse={fuse}: losses {[round(x, 5) for x in res['losses']]}, warm step "
              f"wall {sum(walls) / len(walls) * 1e3:.3f} ms (host clock, synchronised)")
    fused_vs_unfused_batch16(device)


def fused_vs_unfused_batch16(device):
    """tests/test_torch_kernels_cuda.py::test_step_fused_matches_unfused on
    the card: one step at batch 16 (the test's inputs), fused and unfused,
    every output held at TOL."""
    import numpy as np
    import torch

    from repro_torch.convert import params_from_jax
    from repro_torch.lower import frequency_band_batches, paper_cnn_graph, run_torch

    graph = paper_cnn_graph(batch=16, img=IMG)
    x, labels = frequency_band_batches(np.random.RandomState(16), 16, IMG)(0)
    ins = {"x": torch.as_tensor(x, device=device),
           "onehot": torch.as_tensor(np.eye(10, dtype=np.float32)[labels], device=device),
           **params_from_jax(graph.init_params(seed=1), graph, device)}
    fused = run_torch(graph, ins, fuse=True, device=device)
    unfused = run_torch(graph, ins, fuse=False, device=device)

    def units(k) -> float:
        d = (fused[k].double() - unfused[k].double()).abs()
        return float((d / (TOL["atol"] + TOL["rtol"] * unfused[k].double().abs())).max())

    worst = max(fused, key=units)
    err = max_abs(fused[worst], unfused[worst])
    print(f"  batch 16: fused vs unfused, worst {worst} at {units(worst):.4f} of rtol "
          f"{TOL['rtol']} / atol {TOL['atol']} (max_abs {err:.3e})")
    for k in fused:
        torch.testing.assert_close(fused[k], unfused[k], **TOL, msg=f"batch 16 fused/unfused {k}")


def ssd_work(x, la, b, chunk: int) -> tuple[float, float]:
    """Bytes (x, la, b, c read once, y written once) and FLOPs of one scan.

    FLOPs are what the chunked dual form needs, a multiply-add counted as 2.
    Per chunk of Q tokens: the causal half of the score block c b^T, once
    per group (Q(Q+1)/2 * 2N); per head the causal half of (scores * decay)
    x (Q(Q+1)/2 * (2P + 1)), the inter term c h^T and the state update
    x^T (w b) (2QPN each), and the element-wise scalings (Q(2P + N) + 2PN).
    exp is not counted.
    """
    bb, h, s, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    q = min(chunk, s)
    tri = q * (q + 1) / 2
    per_chunk = g * tri * 2 * n + h * (tri * (2 * p + 1) + 4 * q * p * n
                                       + q * (2 * p + n) + 2 * p * n)
    nbytes = (2 * x.numel() * x.element_size() + la.numel() * la.element_size()
              + 2 * b.numel() * b.element_size())
    return float(nbytes), float(bb * (s // q) * per_chunk)


def ssd_inputs(shape, dtype, device, seed: int, *, dt_min: float = 0.0, dt_max: float = 0.1,
               layout: str = "model"):
    """SSD operands with the model's decay: la = -dt * A, A = 1..H, dt in [dt_min, dt_max].

    At dt 0.1 and H 48, la reaches -4.8 per step, and exp(cum_i - cum_j)
    above the diagonal overflows.

    ``layout="model"`` gives the transposed (B,S,H,P) -> (B,H,S,P) views that
    ``ssm_block`` passes; ``"contiguous"`` the same values, contiguous.
    """
    import numpy as np
    import torch

    bb, h, g, s, p, n = shape
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(bb, s, h, p) * 0.5, dtype=torch.float32)
    dt = torch.as_tensor(dt_min + rng.rand(bb, s, h) * (dt_max - dt_min), dtype=torch.float32)
    la = -dt * torch.arange(1, h + 1, dtype=torch.float32)
    b = torch.as_tensor(rng.randn(bb, s, g, n) * 0.3, dtype=torch.float32)
    c = torch.as_tensor(rng.randn(bb, s, g, n) * 0.3, dtype=torch.float32)
    x, b, c = (t.to(device, dtype).transpose(1, 2) for t in (x, b, c))
    la = la.to(device).transpose(1, 2)
    if layout == "contiguous":
        x, la, b, c = (t.contiguous() for t in (x, la, b, c))
    return x, la, b, c


def check_ssd(smoke: Smoke, device, full=(2, 48, 1, 2048, 64, 128), chunk: int = 128):
    """ssd_scan vs its plain chunked version and the sequential ssd_ref; bf16
    on the tensor-core entry also through the rounded-once gate, fp32 on the
    3xTF32 entry also through the RMS gate (MM_RMS, against the fp64
    ssd_ref), whose 1xTF32 and y-via-bf16 controls must be rejected."""
    import torch

    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels import ssd_scan_tf32 as tf32
    from repro_torch.kernels import ssd_scan_wgmma as wgmma
    from repro_torch.kernels.ref import ssd_ref, ssd_rounded_once_share

    bb, h, g, s, p, n = full
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (label, shape, dtype, layout, dt range, seed)
        ("full width f32", full, f32, "model", (0.0, 0.1), 0),
        ("full width bf16", full, bf16, "model", (0.0, 0.1), 1),
        ("full width f32 contiguous", full, f32, "contiguous", (0.0, 0.1), 0),
        ("full width bf16 contiguous", full, bf16, "contiguous", (0.0, 0.1), 1),
        ("G 2 f32", (1, 8, 2, 4 * chunk, p, n), f32, "model", (0.0, 0.1), 2),
        ("G 2 bf16", (1, 8, 2, 4 * chunk, p, n), bf16, "model", (0.0, 0.1), 2),
        ("strong decay f32", (1, h, 1, 2 * chunk, p, n), f32, "model", (0.1, 0.1), 3),
        ("strong decay bf16", (1, h, 1, 2 * chunk, p, n), bf16, "model", (0.1, 0.1), 3),
        # la to -48 per step: cum_i - cum_j cancels in fp32 in any dual form,
        # so the kernel is held to the sequential ssd_ref; vs plain is printed
        ("dt to 1.0 f32", (1, h, 1, 2 * chunk, p, n), f32, "model", (0.0, 1.0), 4),
        ("dt to 1.0 G 2 bf16", (1, h, 2, 2 * chunk, p, n), bf16, "model", (0.0, 1.0), 5),
    ]
    worst, outs, shares, ratios = 0.0, {}, {}, {}
    print(f"{'case':>26} {'max|y|':>9} {'kernel-plain':>12} {'kernel-ref':>11} "
          f"{'plain-ref':>10} {'gate':>8}  entry")
    for label, shape, dtype, layout, (dt_min, dt_max), seed in cases:
        x, la, b, c = ssd_inputs(shape, dtype, device, seed, dt_min=dt_min, dt_max=dt_max,
                                 layout=layout)
        ssd_scan.COUNTER.reset()
        got = ssd_scan.ssd_scan(x, la, b, c, chunk=chunk)
        entries = dict(ssd_scan.COUNTER.entries)
        want = ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk)
        seq = ssd_ref(x, la, b, c)
        torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        e_plain, e_ref = max_abs(got, want), max_abs(got, seq)
        tol = SSD_TOL[str(dtype).split(".")[-1]]
        vs_plain = dt_max < 1.0
        outs[label] = got
        print(f"{label:>26} {scale:>9.4f} {e_plain / scale:>12.2e}{' ' if vs_plain else '*'}"
              f"{e_ref / scale:>10.2e} {max_abs(want, seq) / scale:>10.2e} {tol:>8.0e}  "
              f"{', '.join(entries)}")
        assert entries == {ssd_scan.entry(dtype, p, n, chunk): 1}, f"{label}: launched {entries}"
        assert bool(torch.isfinite(got).all()), f"{label}: non-finite output"
        if vs_plain:
            worst = max(worst, e_plain)
            assert e_plain <= tol * scale, f"{label}: kernel vs plain {e_plain / scale:.2e}"
        assert e_ref <= tol * scale, f"{label}: kernel vs ssd_ref {e_ref / scale:.2e}"
        if ssd_scan.entry(dtype, p, n, chunk) == wgmma.ENTRY and "contiguous" not in label:
            shares[label] = share = ssd_rounded_once_share(got, x, la, b, c)
            print(f"{'':>26} rounded-once share {share:.4%} (gate {ROUNDED_ONCE:.0%}"
                  f"{'' if vs_plain else ', printed, not gated'}); plain version "
                  f"{ssd_rounded_once_share(want, x, la, b, c):.4%}")
            assert not vs_plain or share <= ROUNDED_ONCE, f"{label}: rounded-once share {share:.4%}"
        if ssd_scan.entry(dtype, p, n, chunk) == tf32.ENTRY and vs_plain and \
                "contiguous" not in label:
            ratios[label] = ssd_rms_gate(label, got, want, (x, la, b, c), chunk,
                                         controls=label == "full width f32")
    print("  * printed, not gated")
    for label in ("full width f32", "full width bf16"):
        dtype = f32 if "f32" in label else bf16
        again = ssd_scan.ssd_scan(*ssd_inputs(full, dtype, device, 0 if dtype == f32 else 1),
                                  chunk=chunk)
        assert torch.equal(outs[label], outs[f"{label} contiguous"]), \
            f"{label}: strided and contiguous operands gave different bits"
        assert torch.equal(again, outs[label]), f"{label}: two runs gave different bits"
    print("  full width f32 / bf16: strided == contiguous and run == run, identical bits")

    x, la, b, c = ssd_inputs(full, bf16, device, 1)  # the main path's operands
    want = ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk)
    scale = float(want.float().abs().max())
    for kind in ("one_term", "scores"):
        ctl = control_ssd(kind)(x, la, b, c, chunk=chunk)
        share, band = ssd_rounded_once_share(ctl, x, la, b, c), max_abs(ctl, want) / scale
        print(f"  control {kind} on full width bf16: rounded-once share {share:.4%}, "
              f"{'rejected' if share > ROUNDED_ONCE else 'passes'}; the 1e-2 band reads "
              f"{band:.2e} ({'rejected' if band > SSD_TOL['bfloat16'] else 'passes'})")
        if kind == "one_term":
            assert share > ROUNDED_ONCE, "the rounded-once gate let the one_term control through"
        del ctl
    # the FFMA bf16 entry (still the kernel at other bf16 shapes), held against
    # the plain version and timed beside the tensor-core kernel
    ffma = ssd_scan.launch(ssd_scan.FFMA[bf16], x, la, b, c, chunk=chunk)
    e_ffma = max_abs(ffma, want) / scale
    print(f"  FFMA bf16 entry at full width vs plain: {e_ffma:.2e} of max|y|")
    assert e_ffma <= SSD_TOL["bfloat16"], f"FFMA bf16 entry vs plain {e_ffma:.2e}"
    del ffma
    name = ssd_scan.entry(bf16, p, n, chunk)
    ms = time_ms(lambda: ssd_scan.ssd_scan(x, la, b, c, chunk=chunk))
    ffma_ms = time_ms(lambda: ssd_scan.launch(ssd_scan.FFMA[bf16], x, la, b, c, chunk=chunk))
    plain = time_ms(lambda: ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk), iters=5)
    f32_row = check_ssd_f32(full, chunk, device)
    f32_row["f32_rms_ratio"] = ratios
    passes = kernel_ms(lambda: ssd_scan.ssd_scan(x, la, b, c, chunk=chunk))
    dev = sum(passes.values()) if passes else float("nan")
    nbytes, flops = ssd_work(x, la, b, chunk)
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    print(f"ssd_scan at B {bb}, H {h}, S {s}, P {p}, N {n}, chunk {chunk}, bf16: kernel "
          f"({name}) {ms:.4f} ms by events, {dev:.4f} ms device time in its passes; FFMA bf16 "
          f"entry {ffma_ms:.4f} ms; plain {plain:.4f} ms; fp32 ({f32_row['f32_source']}) "
          f"{f32_row['f32_ms']:.4f} ms; bound {bnd:.5f} ms ({nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.2f} GFLOP, {by}; at the fp32 rate the kernel computes in "
          f"{bound_ms(nbytes, flops)[0]:.5f} ms); no single library call computes SSD")
    for key, kms in sorted(passes.items(), key=lambda kv: -kv[1]):
        print(f"    {kms:9.4f} ms  {key[:90]}")
    sources = {e: f"src/repro_torch/kernels/csrc/{lib}.cu"
               for e, lib in sorted(ssd_scan.ENTRIES.items())}
    smoke.kernels["ssd_scan"] = {
        "name": "ssd_scan",
        "route": "cuda",
        "source": sources[name],
        "sources": sources,
        "replaces": "src/repro/kernels/ssd_scan.py:82",
        "launches": None,
        "launches_by_entry": None,
        "max_abs_err": worst,
        "ms": ms,
        "device_ms": dev,
        "plain_ms": plain,
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": None,
        "ffma_bf16_ms": ffma_ms,
        "rounded_once": shares["full width bf16"],
        "at": f"B {bb}, H {h}, G {g}, S {s:,}, P {p}, N {n}, chunk {chunk}, bf16",
        **f32_row,
    }


def ssd_rms_gate(label, got, want, operands, chunk: int, *, controls: bool) -> float:
    """fp32 SSD on the 3xTF32 entry: RMS error against the fp64 ssd_ref at most
    MM_RMS x the plain version's. With ``controls``, the 1xTF32 product
    (``ssd_scan_tf32.emulate(terms=1)``) and y rounded through bf16 are read
    through the gate and must be rejected."""
    import torch

    from repro_torch.kernels import ssd_scan_tf32 as tf32
    from repro_torch.kernels.ref import ssd_ref

    ref64 = ssd_ref(*operands, compute_dtype=torch.float64)
    ratio = rms_ratio(got, ref64, want)
    text = f"{'':>26} RMS vs fp64 {ratio:.4f} x the plain version's (gate {MM_RMS})"
    if controls:
        one = rms_ratio(tf32.emulate(*operands, chunk=chunk, terms=1), ref64, want)
        via = rms_ratio(got.bfloat16(), ref64, want)
        text += f"; controls 1xTF32 {one:.1f}x, y via bf16 {via:.1f}x (both must be rejected)"
        assert one > MM_RMS and via > MM_RMS, f"{label}: the RMS gate let a control through"
    print(text)
    assert ratio <= MM_RMS, f"{label}: RMS vs fp64 {ratio:.4f} x the plain version's"
    return ratio


def check_ssd_f32(full, chunk: int, device) -> dict:
    """fp32 at full width: the 3xTF32 entry timed beside the FFMA fp32 entry
    (held against the plain version at the band first) and the bound, per-pass
    device time by torch.profiler."""
    import torch

    from repro_torch.kernels import ssd_scan

    f32 = torch.float32
    bb, h, g, s, p, n = full
    x, la, b, c = ssd_inputs(full, f32, device, 0)
    name = ssd_scan.entry(f32, p, n, chunk)
    want = ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk)
    ffma = ssd_scan.launch(ssd_scan.FFMA[f32], x, la, b, c, chunk=chunk)
    e_ffma = max_abs(ffma, want) / float(want.abs().max())
    del ffma
    assert e_ffma <= SSD_TOL["float32"], f"FFMA fp32 entry vs plain {e_ffma:.2e}"
    ms = time_ms(lambda: ssd_scan.ssd_scan(x, la, b, c, chunk=chunk))
    ffma_ms = time_ms(lambda: ssd_scan.launch(ssd_scan.FFMA[f32], x, la, b, c, chunk=chunk),
                      iters=10)
    plain = time_ms(lambda: ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk), iters=5)
    passes = kernel_ms(lambda: ssd_scan.ssd_scan(x, la, b, c, chunk=chunk))
    dev = sum(passes.values()) if passes else float("nan")
    nbytes, flops = ssd_work(x, la, b, chunk)
    bnd, by = bound_ms(nbytes, 3 * flops, "tf32")
    print(f"ssd_scan at B {bb}, H {h}, S {s}, P {p}, N {n}, chunk {chunk}, fp32: kernel ({name}) "
          f"{ms:.4f} ms by events, {dev:.4f} ms device time in its passes; FFMA fp32 entry "
          f"{ffma_ms:.4f} ms (vs plain {e_ffma:.2e} of max|y|); plain {plain:.4f} ms; bound "
          f"{bnd:.5f} ms ({nbytes / 1e6:.2f} MB, 3 x {flops / 1e9:.2f} GFLOP at the tf32 rate, "
          f"{by}; at the fp32-FFMA rate {bound_ms(nbytes, flops)[0]:.5f} ms); "
          f"{ptxas_summary(ssd_scan.ENTRIES[name])}")
    for key, kms in sorted(passes.items(), key=lambda kv: -kv[1]):
        print(f"    {kms:9.4f} ms  {key[:90]}")
    return {"f32_source": f"src/repro_torch/kernels/csrc/{ssd_scan.ENTRIES[name]}.cu",
            "f32_ms": ms, "f32_device_ms": None if math.isnan(dev) else dev,
            "f32_ffma_ms": ffma_ms, "f32_plain_ms": plain, "f32_bound_ms": bnd,
            "f32_bound_by": by}


@contextlib.contextmanager
def routed(mod, fn):
    """Route a kernel module's wrapper to ``fn``.

    The wrapper has the module's counter name (``ssd_scan.ssd_scan``,
    ``flash_attention.flash_attention``); ``ops`` looks it up at call time.
    """
    name = mod.COUNTER.name
    orig = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def plain_route(mod):
    """Route a kernel module's wrapper to its plain version (``<wrapper>_torch``),
    on the card, for comparison."""
    return routed(mod, getattr(mod, f"{mod.COUNTER.name}_torch"))


@contextlib.contextmanager
def event_timer(mod, events: list):
    """Bracket every launch of a kernel module's wrapper with CUDA events (no synchronisation)."""
    import torch

    orig = getattr(mod, mod.COUNTER.name)

    def timed(*args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(*args, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    with routed(mod, timed):
        yield


@contextlib.contextmanager
def recorder(mod, calls: list):
    """Keep the operands, keywords and output of every launch of a kernel module's wrapper."""
    orig = getattr(mod, mod.COUNTER.name)

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out

    with routed(mod, recorded):
        yield


def control_ssd(kind: str):
    """A lower-precision plain SSD, read through the gates of the prefill.

    ``"scores"``: the c b^T block rounded to bf16, one rounding more than
    the kernels make. ``"y_e5m2"``: y rounded to fp8 e5m2 (2 mantissa bits).
    ``"one_term"``: the tensor-core kernel's numerics with each fp32 operand
    of a bf16 product as one bf16 term, not two (``ssd_scan_wgmma.emulate``
    with ``terms=1``).
    """
    import torch

    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels import ssd_scan_wgmma as wgmma

    def one_term(x, la, b, c, *, chunk):
        return wgmma.emulate(x, la, b, c, chunk=chunk, terms=1)

    def y_e5m2(x, la, b, c, *, chunk):
        return ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk).to(torch.float8_e5m2).to(x.dtype)

    def scores_bf16(x, la, b, c, *, chunk):  # ssd_scan_torch, scores rounded
        bb, h, s, p = x.shape
        g, n = b.shape[1], b.shape[3]
        grp, nc = h // g, s // chunk
        xf = x.float().reshape(bb, g, grp, nc, chunk, p)
        laf = la.float().reshape(bb, g, grp, nc, chunk)
        bf = b.float().reshape(bb, g, nc, chunk, n)
        cf = c.float().reshape(bb, g, nc, chunk, n)
        causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
        state = torch.zeros((bb, g, grp, p, n), dtype=torch.float32, device=x.device)
        ys = []
        for ci in range(nc):
            xc, bc, cc = xf[:, :, :, ci], bf[:, :, None, ci], cf[:, :, None, ci]
            cum = torch.cumsum(laf[:, :, :, ci], dim=-1)
            total = cum[..., -1:]
            scores = (cc @ bc.transpose(-1, -2)).bfloat16().float()
            decay = torch.where(causal, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
            y = (scores * decay) @ xc
            y = y + torch.exp(cum)[..., None] * (cc @ state.transpose(-1, -2))
            w = torch.exp(total - cum)[..., None] * bc
            state = torch.exp(total)[..., None] * state + xc.transpose(-1, -2) @ w
            ys.append(y)
        return torch.stack(ys, dim=3).reshape(bb, h, s, p).to(x.dtype)

    return {"scores": scores_bf16, "y_e5m2": y_e5m2, "one_term": one_term}[kind]


def _prefill_runs(params, tokens, cfg, ctx, mod, n_calls: int, warm: int, launch_gate,
                  entry=None):
    """One counted prefill, one through the plain version, ``warm`` timed ones.

    ``mod`` is the kernel module of the path (its wrapper is counted,
    recorded, timed and routed to its plain version; it is called
    ``n_calls`` times a prefill). Every call of the counted prefill is then
    held against the plain version on its own operands (the layer's real
    activations) by ``launch_gate(calls, dtype)``. ``entry`` names the C
    entry each call launches once, or maps each C entry to its launches per
    call; the counted prefill must launch just those.
    """
    import torch

    from repro_torch.models.lm import prefill

    dtype, name = cfg.dtype, mod.COUNTER.name
    torch.cuda.reset_peak_memory_stats()
    mod.COUNTER.reset()
    calls: list = []
    t0 = time.perf_counter()
    with recorder(mod, calls):
        logits = prefill(params, tokens, cfg, ctx)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = (mod.COUNTER.launches, mod.COUNTER.plain_calls)
    entries = dict(mod.COUNTER.entries)
    print(f"  {dtype}: {name} launches / plain calls {counts}"
          f"{f' by entry {entries}' if entries else ''}; first prefill "
          f"{first * 1e3:.1f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    per_call = {entry: 1} if isinstance(entry, str) else entry
    n_launch = n_calls * sum(per_call.values()) if per_call else n_calls
    assert counts == (n_launch, 0), f"{dtype}: expected {n_launch} launches, 0 plain calls"
    assert per_call is None or entries == {e: n_calls * c for e, c in per_call.items()}, \
        f"{dtype}: expected {per_call} launches per call over {n_calls} calls, got {entries}"
    assert logits.shape == (*tokens.shape, cfg.vocab_size) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()), f"{dtype}: non-finite logits"
    launch_gate(calls, dtype)
    del calls
    with plain_route(mod):
        plain = prefill(params, tokens, cfg, ctx)
    torch.cuda.synchronize()
    walls, dev_ms = [], []
    for _ in range(warm):
        events: list = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with event_timer(mod, events):
            prefill(params, tokens, cfg, ctx)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(sum(e0.elapsed_time(e1) for e0, e1 in events))
    wall, dev = sum(walls) / len(walls), sum(dev_ms) / len(dev_ms)
    print(f"  {dtype}: warm prefill wall {wall:.3f} ms (host clock, synchronised, mean "
          f"of {warm}: {[round(w, 3) for w in walls]}); {name} device time "
          f"{dev:.3f} ms per prefill ({n_launch} launches), {dev / wall:.1%} of the wall")
    return logits, plain, counts[0], wall


def profile_prefill(params, tokens, cfg, ctx, warm_wall_ms: float):
    """Device time of one warm prefill by kernel and by kind, from torch.profiler.

    Kinds: the port's kernels (``attn_kernel``, ``attn_wgmma_kernel``,
    ``ssd_kernel``, the ``ssd_wgmma_*`` and ``ssd_tf32_*`` passes and their
    shared ``ssd_chunk_scan``), matrix
    products (cuBLAS), and everything else (element-wise passes, reductions,
    copies). The device's idle share is 1 - (sum of kernel times) / the
    warm wall measured without the profiler.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.lm import prefill

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill(params, tokens, cfg, ctx)
        torch.cuda.synchronize()
    # device-side events only: a CPU op's self device time repeats its kernels'
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(ms for _, ms, _ in rows)
    if not rows:
        print(f"  {cfg.dtype}: the profiler saw no device time")
        return

    def kind(name):
        if any(t in name for t in ("attn_kernel", "attn_wgmma_kernel", "ssd_kernel", "ssd_wgmma",
                                   "ssd_tf32", "ssd_chunk_scan")):
            return "port kernel"
        if any(t in name.lower() for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            return "matmul (cuBLAS)"
        return "other (element-wise, reductions, copies)"

    kinds: dict[str, float] = {}
    for name, ms, _ in rows:
        kinds[kind(name)] = kinds.get(kind(name), 0.0) + ms
    print(f"  {cfg.dtype}: profiled prefill, device time {total:.3f} ms in "
          f"{sum(c for *_, c in rows)} kernel launches; idle share of the {warm_wall_ms:.3f} ms "
          f"warm wall {1 - total / warm_wall_ms:.1%}")
    for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"    {k:>42}: {ms:9.3f} ms ({ms / total:.1%})")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"    {ms:9.3f} ms {count:>5}x  {name[:90]}")


def _ssd_launch_gate(calls, dtype):
    """Each SSD launch vs the plain SSD at SSD_TOL; bf16 scores must fail in
    fp32. Launches of the bf16 tensor-core entry also read layer 0 through
    the rounded-once gate, of the fp32 one through the RMS gate (with its
    1xTF32 control)."""
    import torch

    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels import ssd_scan_tf32 as tf32
    from repro_torch.kernels import ssd_scan_wgmma as wgmma
    from repro_torch.kernels.ref import ssd_rounded_once_share

    tol = SSD_TOL[str(dtype).split(".")[-1]]
    rel = []
    for i, (args, kw, y) in enumerate(calls):
        want = ssd_scan.ssd_scan_torch(*args, **kw)
        scale = float(want.float().abs().max())
        rel.append(max_abs(y, want) / scale)
        if i == 0:
            ctl = max_abs(control_ssd("scores")(*args, **kw), want) / scale
            x, _, b, _ = args
            q = min(kw["chunk"], x.shape[2])
            if ssd_scan.entry(x.dtype, x.shape[3], b.shape[3], q) == wgmma.ENTRY:
                share = ssd_rounded_once_share(y, *args)
                print(f"  {dtype}: layer 0's SSD launch, rounded-once share {share:.4%} (gate "
                      f"{ROUNDED_ONCE:.0%}); plain version "
                      f"{ssd_rounded_once_share(want, *args):.4%}")
                assert share <= ROUNDED_ONCE, f"layer 0 SSD rounded-once share {share:.4%}"
            if ssd_scan.entry(x.dtype, x.shape[3], b.shape[3], q) == tf32.ENTRY:
                print(f"  {dtype}: layer 0's SSD launch through the RMS gate:")
                ssd_rms_gate("layer 0", y, want, args, q, controls=True)
    worst = max(range(len(rel)), key=rel.__getitem__)
    print(f"  {dtype}: SSD kernel vs plain on each layer's own operands, of max|y|: worst "
          f"{rel[worst]:.2e} (layer {worst}), median {sorted(rel)[len(rel) // 2]:.2e} "
          f"(gate {tol:.0e}); control scores in bf16 on layer 0: {ctl:.2e}, "
          f"{'rejected' if ctl > tol else 'passes'}")
    assert rel[worst] <= tol, f"{dtype}: layer {worst} SSD kernel vs plain {rel[worst]:.2e}"
    # the fp32 band must see one bf16 rounding of the scores. The bf16 band is
    # one bf16 ulp of y wide and cannot; there the rounded-once gate above
    # reads the tensor-core kernel.
    assert dtype != torch.float32 or ctl > tol, "the fp32 gate let bf16 scores through"


def _block_gate(params, tokens, cfg, ctx):
    """Layer 0's ssm_block at the prefill's own activations, kernel vs plain SSD."""
    import torch

    from repro_torch.kernels import ssd_scan
    from repro_torch.models.blocks import apply_norm
    from repro_torch.models.lm import embed_inputs
    from repro_torch.models.ssm import ssm_block

    layer = params["decoder"]["units"][0][0]
    with torch.inference_mode():
        h = apply_norm(embed_inputs(params, tokens, cfg), layer["norm1"], cfg.norm_type,
                       cfg.norm_eps)
        got = ssm_block(h, layer["ssm"], cfg, chunk=ctx.ssd_chunk)
        with plain_route(ssd_scan):
            want = ssm_block(h, layer["ssm"], cfg, chunk=ctx.ssd_chunk)
    scale, err = float(want.float().abs().max()), max_abs(got, want)
    print(f"  {cfg.dtype}: layer-0 ssm_block, kernel vs plain SSD: max|out| {scale:.4f}, "
          f"max_abs {err:.3e} = {err / scale:.2e} of it (gate {BLOCK_TOL:.0e})")
    assert bool(torch.isfinite(got).all()), "layer-0 ssm_block: non-finite output"
    assert err <= BLOCK_TOL * scale, f"layer-0 ssm_block kernel vs plain {err / scale:.2e}"


def prefill_path(smoke: Smoke, device, cfg=None, batch: int = PREFILL_BATCH,
                 seq: int = PREFILL_SEQ, token_high: int = TOKEN_HIGH, warm: int = 3):
    """lm.prefill of Mamba-2 780M at full width and depth, bf16 then fp32.

    fp32 runs on the bf16 weights widened, so it is also the reference the
    bf16 runs are measured against. Gates: in both dtypes each of the 48
    SSD launches against the plain SSD on its own operands (SSD_TOL), and
    layer 0's ssm_block (BLOCK_TOL in bf16); fp32 logits, kernel vs plain
    SSD, within 1e-4 of max|logits|; in bf16 the kernel's error against
    that fp32 prefill no larger than the plain SSD's (1.25x at the max,
    1.1x in the mean). Lower-precision controls are read through the
    gates: the fp32 per-layer gate must reject scores rounded to bf16, the
    ratio gate y rounded to fp8 e5m2 (it is coarse: bf16 scores pass it).
    Every bf16 launch is of the bf16 tensor-core entry (layer 0's also
    through the rounded-once gate), every fp32 launch of the 3xTF32 entry
    ``ssd_scan_f32_tf32`` (layer 0's also through the RMS gate). In bf16
    the kernel and the plain version differ in about one element of y in
    five hundred by one ulp (two-term operands, fp32 sums in another
    order); 48 layers carry those flips to several percent of
    max|logits|, so their direct difference at the logits is printed, not
    gated.
    """
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.models.config import ParallelCtx
    from repro_torch.models.lm import init_lm, prefill

    cfg = cfg or get_config("mamba2_780m")
    ctx = ParallelCtx()
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, token_high, (batch, seq)),
                             device=device)
    n_ssd = sum(cfg.pattern[i % len(cfg.pattern)][0] == "ssm" for i in range(cfg.n_layers))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, batch {batch} x {seq} tokens, {n_ssd} SSD layers")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    print(f"  init_lm(seed=0): {sum(p.numel() for p in params.parameters()):,} parameters, "
          f"{cfg.dtype}, in {time.perf_counter() - t0:.2f} s")
    q = min(ctx.ssd_chunk, seq)
    entry16, entry32 = (ssd_scan.entry(dt, cfg.ssm_headdim, cfg.ssm_state, q)
                        for dt in (cfg.dtype, torch.float32))
    if (cfg.ssm_headdim, cfg.ssm_state, q) == (64, 128, 128):  # the 780M's: tensor cores
        assert (entry16, entry32) == ("ssd_scan_bf16_wgmma", "ssd_scan_f32_tf32"), \
            (entry16, entry32)
    k16, p16, launches, wall = _prefill_runs(params, tokens, cfg, ctx, ssd_scan, n_ssd, warm,
                                             _ssd_launch_gate, entry=entry16)
    profile_prefill(params, tokens, cfg, ctx, wall)
    _block_gate(params, tokens, cfg, ctx)
    controls = {}
    for kind in ("scores", "y_e5m2"):
        with routed(ssd_scan, control_ssd(kind)):
            controls[kind] = prefill(params, tokens, cfg, ctx)
    params.to(torch.float32)  # in place: the same weights, widened
    k32, p32, launches32, _ = _prefill_runs(params, tokens, cfg.with_(dtype=torch.float32), ctx,
                                            ssd_scan, n_ssd, 1, _ssd_launch_gate, entry=entry32)
    del params
    scale = float(p32.abs().max())
    e32 = max_abs(k32, p32)
    print(f"  float32: kernel vs plain-SSD prefill: max|logits| {scale:.4f}, max_abs "
          f"{e32:.3e} = {e32 / scale:.2e} of max|logits| (gate {PREFILL_TOL['float32']:.0e})")
    assert e32 <= PREFILL_TOL["float32"] * scale, f"fp32 prefill kernel vs plain {e32 / scale:.2e}"

    def vs_fp32(logits):
        e = (logits - p32).abs()
        return float(e.max()), float(e.mean())

    ep_max, ep_mean = vs_fp32(p16)
    passes = {}
    print(f"  bfloat16 vs the fp32 prefill, of max|logits|: plain SSD max "
          f"{ep_max / scale:.3e} mean {ep_mean / scale:.3e}; kernel vs plain directly "
          f"{max_abs(k16, p16) / scale:.3e}")
    for name, logits in (("kernel", k16), *((f"control {k}", v) for k, v in controls.items())):
        e_max, e_mean = vs_fp32(logits)
        passes[name] = e_max <= 1.25 * ep_max and e_mean <= 1.1 * ep_mean
        print(f"    {name:>16}: max {e_max / scale:.3e} ({e_max / ep_max:.3f}x plain), mean "
              f"{e_mean / scale:.3e} ({e_mean / ep_mean:.4f}x plain): ratio gate "
              f"{'passes' if passes[name] else 'rejects'}")
    assert passes["kernel"], \
        "bf16 prefill through the kernel is further from fp32 than through the plain SSD"
    assert not passes["control y_e5m2"], "the ratio gate let y in fp8 e5m2 through"
    smoke.kernels["ssd_scan"]["launches"] = launches
    smoke.kernels["ssd_scan"]["launches_by_entry"] = {f"{entry16} (bf16 prefill)": launches,
                                                      f"{entry32} (fp32 prefill)": launches32}
    torch.cuda.empty_cache()


def attn_gate(got, want) -> float:
    """``got`` against ``want`` in units of the attention gate: at most 1 passes.

    fp32: elementwise |got - want| <= atol + rtol |want| (ATTN_F32); bf16:
    max|got - want| <= ATTN_BF16 max|want|.
    """
    import torch

    d = (got.double() - want.double()).abs()
    if want.dtype == torch.float32:
        return float((d / (ATTN_F32["atol"] + ATTN_F32["rtol"] * want.double().abs())).max())
    return float(d.max()) / (ATTN_BF16 * float(want.double().abs().max()))


# lower-precision controls read through the attention gates of each dtype;
# every gate must reject each of them
CONTROLS = {"float32": ("qk_bf16", "p_bf16"), "bfloat16": ("o_e5m2",)}


def _controls(ctl: dict) -> str:
    return ", ".join(f"{k} {u:.3f} ({'rejected' if u > 1 else 'passes'})" for k, u in ctl.items())


def control_attention(kind: str):
    """A lower-precision plain attention, read through the attention gates.

    ``"qk_bf16"``: q and k rounded to bf16 before the scores (what a bf16
    tensor-core score product would do to fp32 operands); ``"o_e5m2"``: o
    rounded to fp8 e5m2 (2 mantissa bits); ``"p_bf16"``: p rounded to bf16
    before the p v product, l summed from the fp32 p (what a ``wgmma`` p v
    product would do), as one dense softmax per row.
    """
    import torch

    from repro_torch.kernels import flash_attention as fa

    def qk_bf16(q, k, v, **kw):
        return fa.flash_attention_torch(q.bfloat16().to(q.dtype), k.bfloat16().to(k.dtype), v,
                                        **kw)

    def o_e5m2(q, k, v, **kw):
        return fa.flash_attention_torch(q, k, v, **kw).to(torch.float8_e5m2).to(q.dtype)

    def p_bf16(q, k, v, *, causal=True, window=None, sm_scale=None):
        b, hq, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        scale = d**-0.5 if sm_scale is None else sm_scale
        s = q.float().reshape(b, hkv, hq // hkv, sq, d) @ k.float()[:, :, None].transpose(-1, -2)
        i = torch.arange(sq, device=q.device)[:, None]
        j = torch.arange(skv, device=q.device)[None, :]
        mask = (j <= i) if causal else torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        if window is not None:
            mask &= j > i - window
        s = (s * scale).masked_fill(~mask, float("-inf"))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True).clamp_min(fa.NEG_INF))
        l = p.sum(dim=-1, keepdim=True)
        o = (p.bfloat16().float() @ v.float()[:, :, None]) / torch.where(l == 0, 1.0, l)
        return o.reshape(b, hq, sq, d).to(q.dtype)

    return {"qk_bf16": qk_bf16, "o_e5m2": o_e5m2, "p_bf16": p_bf16}[kind]


def attention_work(q, k, *, causal: bool, window) -> tuple[float, float]:
    """Bytes (q, k, v read once, o written once) and FLOPs of one attention call.

    FLOPs are 4 D per visible (query, key) pair: the q . k and p v
    multiply-adds, counted as 2 each; the softmax is not counted.
    """
    import numpy as np

    bb, hq, sq, d = q.shape
    skv = k.shape[2]
    i = np.arange(sq)
    hi = np.minimum(skv, i + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(sq, np.int64)
    pairs = float(np.maximum(0, hi - lo).sum()) * bb * hq
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return float(nbytes), 4.0 * d * pairs


def attention_inputs(b, hq, hkv, sq, skv, d, dtype, device, seed: int, *,
                     layout: str = "strided"):
    """q, k, v of 0.3 std from numpy.

    ``layout="strided"`` gives (B, S, H, D) -> (B, H, S, D) transposed views,
    as ``attention_block`` passes v; ``"contiguous"`` the same values,
    contiguous.
    """
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    q, k, v = (torch.as_tensor(rng.randn(b, s, h, d) * 0.3, dtype=torch.float32)
               .to(device, dtype).transpose(1, 2)
               for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    return q, k, v


def check_attention(smoke: Smoke, device, seq: int = QWEN_SEQ):
    """flash_attention vs its plain version and the dense attention_ref; bf16
    at D 64 / 128 (the tensor-core kernel) also through the rounded-once gate."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_tf32 as tf32
    from repro_torch.kernels import flash_attention_wgmma as wgmma
    from repro_torch.kernels.ref import attention_ref, rounded_once_share

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (label, (B, Hq, Hkv, Sq, Skv, D), window, dtype, seed)
        ("qwen prefill f32", (2, 16, 16, seq, seq, 64), None, f32, 0),
        ("qwen prefill bf16", (2, 16, 16, seq, seq, 64), None, bf16, 1),
        ("GQA 32/8 D 128 f32", (1, 32, 8, seq, seq, 128), None, f32, 2),
        ("GQA 32/8 D 128 bf16", (1, 32, 8, seq, seq, 128), None, bf16, 2),
        ("MQA 10/1 D 256 window f32", (1, 10, 1, 2 * seq, 2 * seq, 256), seq, f32, 3),
        # plain: KV blocks 512 + 88; kernel: tiles 9 x 64 + 24, in q and in kv
        ("KV tail 600 f32", (2, 16, 16, 600, 600, 64), None, f32, 4),
        ("no visible key f32", (1, 4, 2, 256, 64, 64), 32, f32, 5),
        ("window 1024 f32", (1, 16, 16, seq, seq, 64), 1024, f32, 6),
    ]
    worst, outs, ratios = 0.0, {}, {}
    print(f"{'case':>26} {'max|o|':>8} {'kernel-plain':>12} {'kernel-ref':>11} "
          f"{'plain-ref':>10}  (in units of the gate)  entry")
    for label, shape, window, dtype, seed in cases:
        q, k, v = attention_inputs(*shape, dtype, device, seed)
        kw = {"causal": True, "window": window}
        fa.COUNTER.reset()
        got = fa.flash_attention(q, k, v, **kw)
        entries = dict(fa.COUNTER.entries)
        want = fa.flash_attention_torch(q, k, v, **kw)
        dense = attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        e_plain, e_ref = attn_gate(got, want), attn_gate(got, dense)
        outs[label] = got
        worst = max(worst, max_abs(got, want))
        print(f"{label:>26} {float(want.float().abs().max()):>8.4f} {e_plain:>12.3f} "
              f"{e_ref:>11.3f} {attn_gate(want, dense):>10.3f}  {', '.join(entries)}")
        entry = fa.entry(dtype, shape[5], window)
        want_entries = fa.launches_of(dtype, shape[3], shape[4], shape[5], window=window)
        assert entries == want_entries, f"{label}: launched {entries}, not {want_entries}"
        assert bool(torch.isfinite(got).all()), f"{label}: non-finite output"
        assert got.dtype == dtype and got.shape == q.shape, f"{label}: {got.dtype} {got.shape}"
        assert e_plain <= 1 and e_ref <= 1, f"{label}: kernel vs plain {e_plain:.3f}, vs ref {e_ref:.3f} of the gate"
        if entry == wgmma.ENTRY:
            share = rounded_once_share(got, q, k, v, **kw)
            print(f"{'':>26} rounded-once share {share:.4%} (gate {ROUNDED_ONCE:.0%}); "
                  f"plain version {rounded_once_share(want, q, k, v, **kw):.4%}")
            assert share <= ROUNDED_ONCE, f"{label}: rounded-once share {share:.4%}"
        if entry == tf32.ENTRY:
            ref64 = attention_ref(q, k, v, compute_dtype=torch.float64, **kw)
            ratios[label] = ratio = rms_ratio(got, ref64, want)
            print(f"{'':>26} RMS vs fp64 {ratio:.4f} x the plain version's (gate {MM_RMS})")
            assert ratio <= MM_RMS, f"{label}: RMS vs fp64 {ratio:.4f} x plain's"
            if label == "qwen prefill f32":
                # rows that see fewer than 96 keys come from the FFMA entry (ROADMAP C5)
                r = fa.ffma_rows(shape[3], shape[4], True, window)
                first = rms_ratio(got[:, :, :r], ref64[:, :, :r], want[:, :, :r])
                ratios[f"qwen prefill f32, rows < {r}"] = first
                tc_first = rms_ratio(fa.launch(tf32.ENTRY, q, k, v, **kw)[:, :, :r],
                                     ref64[:, :, :r], want[:, :, :r])
                print(f"{'':>26} its first {r} rows (each sees at most {r} keys, from the "
                      f"FFMA entry): RMS vs fp64 {first:.4f} x the plain version's (gate "
                      f"{MM_RMS}); on the 3xTF32 entry alone {tc_first:.4f}")
                assert first <= MM_RMS, f"{label}: first {r} rows RMS {first:.4f} x plain's"
                ctl = {"1xTF32": tf32.emulate(q, k, v, terms=1, **kw),
                       **{kind: control_attention(kind)(q, k, v, **kw)
                          for kind in CONTROLS["float32"]}}
                for kind, o in ctl.items():
                    r = rms_ratio(o, ref64, want)
                    print(f"{'':>26} control {kind}: RMS {r:.1f}x ("
                          f"{'rejected' if r > MM_RMS else 'passes'}); the band reads "
                          f"{attn_gate(o, want):.3f}")
                    assert r > MM_RMS, f"the attention RMS gate let the {kind} control through"
                del ctl
            del ref64
    none = outs["no visible key f32"]
    assert not bool(none[:, :, 95:].any()), "rows with no visible key are not exactly 0"
    assert bool((none[:, :, :95].abs().amax(dim=-1) > 0).all())
    print("  rows >= 95 with no visible key: exactly 0")

    for label, shape, dtype, seed in (("qwen prefill f32", (2, 16, 16, seq, seq, 64), f32, 0),
                                      ("qwen prefill bf16", (2, 16, 16, seq, seq, 64), bf16, 1),
                                      ("GQA 32/8 D 128 f32", (1, 32, 8, seq, seq, 128), f32, 2),
                                      ("GQA 32/8 D 128 bf16", (1, 32, 8, seq, seq, 128), bf16, 2)):
        same = fa.flash_attention(*attention_inputs(*shape, dtype, device, seed,
                                                    layout="contiguous"))
        again = fa.flash_attention(*attention_inputs(*shape, dtype, device, seed))
        assert torch.equal(same, outs[label]), f"{label}: strided and contiguous operands differ"
        assert torch.equal(again, outs[label]), f"{label}: two runs gave different bits"
    print("  qwen and GQA D 128, f32 and bf16: strided == contiguous and run == run, identical "
          "bits")

    for label, kind in (("qwen prefill f32", "qk_bf16"), ("qwen prefill f32", "p_bf16"),
                        ("qwen prefill bf16", "o_e5m2")):
        dtype = f32 if "f32" in label else bf16
        q, k, v = attention_inputs(2, 16, 16, seq, seq, 64, dtype, device, 0 if dtype == f32 else 1)
        want = fa.flash_attention_torch(q, k, v)
        ctl = attn_gate(control_attention(kind)(q, k, v), want)
        print(f"  control {kind} on {label}: {ctl:.3f} of the gate, "
              f"{'rejected' if ctl > 1 else 'passes'}")
        assert ctl > 1, f"the {dtype} gate let the {kind} control through"
    q, k, v = attention_inputs(2, 16, 16, seq, seq, 64, bf16, device, 1)
    ctl = rounded_once_share(control_attention("p_bf16")(q, k, v), q, k, v)
    print(f"  control p_bf16 (one bf16 term of p) on qwen prefill bf16: rounded-once share "
          f"{ctl:.4%}, {'rejected' if ctl > ROUNDED_ONCE else 'passes'}")
    assert ctl > ROUNDED_ONCE, "the rounded-once gate let the p_bf16 control through"

    # the FFMA bf16 entry at D 64 (still the kernel at D 16, 32 and 256), held
    # against the plain version and timed beside the tensor-core kernel
    ffma = fa.launch("flash_attention_bf16", q, k, v)
    e_ffma = attn_gate(ffma, fa.flash_attention_torch(q, k, v))
    print(f"  FFMA bf16 entry at the qwen shape vs plain: {e_ffma:.3f} of the gate")
    assert e_ffma <= 1, f"FFMA bf16 entry vs plain {e_ffma:.3f} of the gate"
    q32, k32, v32 = attention_inputs(2, 16, 16, seq, seq, 64, f32, device, 0)
    e_ffma32 = attn_gate(fa.launch("flash_attention_f32", q32, k32, v32),
                         fa.flash_attention_torch(q32, k32, v32))
    print(f"  FFMA fp32 entry at the qwen shape vs plain: {e_ffma32:.3f} of the gate")
    assert e_ffma32 <= 1, f"FFMA fp32 entry vs plain {e_ffma32:.3f} of the gate"
    del q32, k32, v32
    times, bounds = {}, {}
    for dtype in (f32, bf16):
        q, k, v = attention_inputs(2, 16, 16, seq, seq, 64, dtype, device, 1)
        times[dtype] = (
            time_ms(lambda: fa.flash_attention(q, k, v)),
            time_ms(lambda: fa.flash_attention_torch(q, k, v), iters=5),
            time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                           enable_gqa=False)),
        )
        nbytes, flops = attention_work(q, k, causal=True, window=None)
        # fp32 on the tensor cores: three tf32 products for each product
        bounds[dtype] = bnd, by = (bound_ms(nbytes, 3 * flops, "tf32") if dtype == f32
                                   else bound_ms(nbytes, flops, str(dtype).split(".")[-1]))
        ms, plain, lib = times[dtype]
        print(f"flash_attention at B 2, H 16, S {seq}, D 64, causal, {dtype}: kernel "
              f"({fa.entry(dtype, 64)}) {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, "
              f"bound {bnd:.5f} ms ({nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP, {by}; at the "
              f"fp32-FFMA rate {bound_ms(nbytes, flops)[0]:.5f} ms)")
        if dtype == f32:
            ffma32_ms = time_ms(lambda: fa.launch("flash_attention_f32", q, k, v))
            print(f"  the FFMA fp32 entry (flash_attention.cu) at the same fp32 shape: "
                  f"{ffma32_ms:.4f} ms")
    ffma_ms = time_ms(lambda: fa.launch("flash_attention_bf16", q, k, v))
    print(f"  the FFMA bf16 entry (flash_attention.cu) at the same bf16 shape: {ffma_ms:.4f} ms")
    ms, plain, lib = times[bf16]
    bnd, by = bounds[bf16]
    smoke.kernels["flash_attention"] = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:113",
        "launches": None,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": lib,
        "at": "B 2, H 16, S 2,048, D 64, causal, bf16",
        "f32_source": "src/repro_torch/kernels/csrc/flash_attention_tf32.cu",
        "f32_ms": times[f32][0],
        "f32_ffma_ms": ffma32_ms,
        "f32_plain_ms": times[f32][1],
        "f32_library_ms": times[f32][2],
        "f32_bound_ms": bounds[f32][0],
        "f32_rms_ratio": ratios,
    }


def _attn_launch_gate(calls, dtype):
    """Each attention launch vs the plain version; a control on layer 0 must fail.

    Launches of the bf16 tensor-core kernel also read layer 0 through the
    rounded-once gate, with the p_bf16 control, which it must reject; those
    of the fp32 one through the RMS gate, with the 1xTF32, qk_bf16 and
    p_bf16 controls, which it must reject.
    """
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_tf32 as tf32
    from repro_torch.kernels import flash_attention_wgmma as wgmma
    from repro_torch.kernels.ref import attention_ref, rounded_once_share

    kinds = CONTROLS[str(dtype).split(".")[-1]]
    units, ctl, shares, ratios = [], {}, None, None
    for i, (args, kw, o) in enumerate(calls):
        want = fa.flash_attention_torch(*args, **kw)
        units.append(attn_gate(o, want))
        if i == 0:
            ctl = {kind: attn_gate(control_attention(kind)(*args, **kw), want) for kind in kinds}
            entry = fa.entry(dtype, args[0].shape[3], kw.get("window"))
            if entry == wgmma.ENTRY:
                shares = [rounded_once_share(x, *args, **kw) for x in
                          (o, want, control_attention("p_bf16")(*args, **kw))]
            elif entry == tf32.ENTRY:
                ref64 = attention_ref(*args, compute_dtype=torch.float64, **kw)
                ratios = {"kernel": rms_ratio(o, ref64, want),
                          "1xTF32": rms_ratio(tf32.emulate(*args, terms=1, **kw), ref64, want),
                          **{kind: rms_ratio(control_attention(kind)(*args, **kw), ref64, want)
                             for kind in kinds}}
                del ref64
    worst = max(range(len(units)), key=units.__getitem__)
    print(f"  {dtype}: attention kernel vs plain on each layer's own operands, in units of "
          f"the gate: worst {units[worst]:.3f} (layer {worst}), median "
          f"{sorted(units)[len(units) // 2]:.3f}; controls on layer 0: {_controls(ctl)}")
    assert units[worst] <= 1, f"{dtype}: layer {worst} attention kernel vs plain {units[worst]:.3f}"
    for kind, u in ctl.items():
        assert u > 1, f"the {dtype} per-layer gate let the {kind} control through"
    if shares is not None:
        print(f"  {dtype}: layer 0's launch, rounded-once share {shares[0]:.4%} (gate "
              f"{ROUNDED_ONCE:.0%}); plain version {shares[1]:.4%}; control p_bf16 "
              f"{shares[2]:.4%}, {'rejected' if shares[2] > ROUNDED_ONCE else 'passes'}")
        assert shares[0] <= ROUNDED_ONCE, f"layer 0 rounded-once share {shares[0]:.4%}"
        assert shares[2] > ROUNDED_ONCE, "the layer-0 rounded-once gate let p_bf16 through"
    if ratios is not None:
        r = ratios.pop("kernel")
        print(f"  {dtype}: layer 0's launch, RMS vs fp64 {r:.4f} x the plain version's (gate "
              f"{MM_RMS}); controls: " + ", ".join(
                  f"{k} {u:.1f}x ({'rejected' if u > MM_RMS else 'passes'})"
                  for k, u in ratios.items()))
        assert r <= MM_RMS, f"layer 0 attention RMS vs fp64 {r:.4f} x the plain version's"
        for kind, u in ratios.items():
            assert u > MM_RMS, f"the layer-0 RMS gate let the {kind} control through"


def _attn_block_gate(params, tokens, cfg):
    """Layer 0's attention_block at the prefill's own activations, kernel vs plain."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import attention_block
    from repro_torch.models.blocks import apply_norm
    from repro_torch.models.lm import embed_inputs

    layer = params["decoder"]["units"][0][0]
    kinds = CONTROLS[str(cfg.dtype).split(".")[-1]]
    with torch.inference_mode():
        h = apply_norm(embed_inputs(params, tokens, cfg), layer["norm1"], cfg.norm_type,
                       cfg.norm_eps)

        def block():
            return attention_block(h, layer["attn"], cfg)

        got = block()
        with plain_route(fa):
            want = block()
        ctl = {}
        for kind in kinds:
            with routed(fa, control_attention(kind)):
                ctl[kind] = attn_gate(block(), want)
    err = attn_gate(got, want)
    print(f"  {cfg.dtype}: layer-0 attention_block, kernel vs plain: max|out| "
          f"{float(want.float().abs().max()):.4f}, max_abs {max_abs(got, want):.3e} = "
          f"{err:.3f} of the gate; controls {_controls(ctl)}")
    assert bool(torch.isfinite(got).all()), "layer-0 attention_block: non-finite output"
    assert err <= 1, f"layer-0 attention_block kernel vs plain {err:.3f} of the gate"
    for kind, u in ctl.items():
        assert u > 1, f"the layer-0 block gate let the {kind} control through"


def qwen_prefill_path(smoke: Smoke, device, cfg=None, batch: int = QWEN_BATCH,
                      seq: int = QWEN_SEQ, token_high: int = QWEN_TOKEN_HIGH, warm: int = 3):
    """lm.prefill of Qwen1.5-0.5B at full width and depth, bf16 then fp32.

    fp32 runs on the bf16 weights widened. bf16 launches only the bf16
    tensor-core entry (24 of 24), fp32 the 3xTF32 one and, for the first 96
    query rows of each call, the FFMA one (24 of each). Gates: in both dtypes each
    of the 24 attention launches against the plain version on its own
    operands, and layer 0's attention_block (ATTN_F32 / ATTN_BF16); in bf16
    layer 0's launch through the rounded-once gate; fp32 logits, kernel vs
    plain attention, within 1e-4 of max|logits|. A control is read through
    each gate and must fail: q and k rounded to bf16 (fp32 gates), p rounded
    to bf16 before p v (fp32 gates and the rounded-once gate), o rounded to
    fp8 e5m2 (bf16 gates).
    """
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.config import ParallelCtx
    from repro_torch.models.lm import init_lm, prefill

    cfg = cfg or get_config("qwen1_5_0_5b")
    ctx = ParallelCtx()
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, token_high, (batch, seq)),
                             device=device)
    n_attn = sum(cfg.pattern[i % len(cfg.pattern)][0] in ("attn", "swa")
                 for i in range(cfg.n_layers))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"x {cfg.head_dim}, vocab {cfg.vocab_size}, batch {batch} x {seq} tokens, "
          f"{n_attn} attention layers")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    print(f"  init_lm(seed=0): {sum(p.numel() for p in params.parameters()):,} parameters, "
          f"{cfg.dtype}, in {time.perf_counter() - t0:.2f} s")
    k16, p16, launches, wall = _prefill_runs(params, tokens, cfg, ctx, fa, n_attn, warm,
                                             _attn_launch_gate,
                                             fa.launches_of(cfg.dtype, seq, seq, cfg.head_dim))
    profile_prefill(params, tokens, cfg, ctx, wall)
    _attn_block_gate(params, tokens, cfg)
    params.to(torch.float32)  # in place: the same weights, widened
    cfg32 = cfg.with_(dtype=torch.float32)
    per_call32 = fa.launches_of(cfg32.dtype, seq, seq, cfg.head_dim)
    k32, p32, launches32, wall = _prefill_runs(params, tokens, cfg32, ctx, fa, n_attn, warm,
                                               _attn_launch_gate, per_call32)
    profile_prefill(params, tokens, cfg32, ctx, wall)
    _attn_block_gate(params, tokens, cfg32)
    scale = float(p32.abs().max())
    tol = PREFILL_TOL["float32"]
    ctl = {}
    for kind in CONTROLS["float32"]:
        with routed(fa, control_attention(kind)):
            ctl[kind] = max_abs(prefill(params, tokens, cfg32, ctx), p32) / (tol * scale)
    del params
    e32 = max_abs(k32, p32)
    print(f"  float32: kernel vs plain-attention prefill: max|logits| {scale:.4f}, max_abs "
          f"{e32:.3e} = {e32 / scale:.2e} of max|logits| (gate {tol:.0e}); controls, in "
          f"units of the gate: {_controls(ctl)}")
    assert e32 <= tol * scale, f"fp32 prefill kernel vs plain {e32 / scale:.2e}"
    for kind, u in ctl.items():
        assert u > 1, f"the fp32 logits gate let the {kind} control through"
    print(f"  bfloat16 vs the fp32 prefill, of max|logits| (printed, not gated): kernel max "
          f"{max_abs(k16, p32) / scale:.3e} mean {float((k16 - p32).abs().mean()) / scale:.3e}; "
          f"plain attention max {max_abs(p16, p32) / scale:.3e} mean "
          f"{float((p16 - p32).abs().mean()) / scale:.3e}; kernel vs plain directly "
          f"{max_abs(k16, p16) / scale:.3e}")
    smoke.kernels["flash_attention"]["launches"] = launches
    smoke.kernels["flash_attention"]["launches_by_entry"] = {
        f"{fa.entry(cfg.dtype, cfg.head_dim)} ({cfg.dtype} prefill)": launches,
        **{f"{e} (fp32 prefill)": n_attn * c for e, c in per_call32.items()}}
    torch.cuda.empty_cache()


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def seeded(shape, dtype, device, seed: int, scale: float = 1.0):
    """N(0, scale^2) values made on ``device`` from ``seed``, in ``dtype``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def conv_geometry(h, w, k, stride, pad):
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def mm_cases(layers=GOOGLENET, batch: int = NTX_BATCH, big: int = 1024):
    """(label, M, K, N, dtype): each layer's im2col product in fp32 and bf16,
    and kernels_bench's big^3 in fp32."""
    import torch

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, h, w, cin, k, s, p, cout in layers:
            oh, ow = conv_geometry(h, w, k, s, p)
            cases.append((f"{label} {dtype_name(dtype)}", batch * oh * ow, k * k * cin, cout,
                          dtype))
    cases.append((f"{big}^3 float32", big, big, big, torch.float32))
    return cases


def rms(x) -> float:
    return float(x.double().square().mean().sqrt())


def rms_ratio(got, ref64, plain) -> float:
    """RMS error of ``got`` against the fp64 result over the plain version's."""
    return rms(got.double() - ref64) / max(rms(plain.double() - ref64), 1e-300)


def check_ntx_matmul(smoke: Smoke, device, cases=None, comp_shape=COMP_SHAPE):
    """ops.matmul, plain and compensated, vs ntx_matmul_torch and fp64.

    First the path: every case through ``ops.matmul`` in both modes, with
    the launch counts set to 0 just before and read just after; all go to the
    tensor-core GEMM of K-tile partials (``csrc/ntx_gemm_wgmma.cu``), none to
    the FFMA entry. Then, per call: the kernel vs the plain version in the
    same mode at the band of tests/kernels/test_ntx_matmul.py, its RMS error
    against the fp64 product at most MM_RMS x the plain version's, the same
    bits on a second run. The FFMA entry (``csrc/ntx_matmul.cu``, by name) is
    timed beside the kernel at L1 in fp32 and bf16, and a forced split must
    give the bits of the planned one. The compensation gate uses integer
    operands on which every K tile sums exactly and the total crosses 2**24:
    the compensated kernel must equal the fp64 product rounded once and the
    compensated plain version bit for bit; the uncompensated kernel, read
    through the same gate, is the control and must be rejected. The band and
    the RMS gate have their own controls (:func:`check_mm_controls`). Bound:
    fp32 operands at three tf32 products each at the tf32 rate (the
    fp32-FFMA figure printed beside it), bf16 at the bf16 rate.
    """
    import torch

    from repro_torch.kernels import gemm_wgmma as gemm
    from repro_torch.kernels import ntx_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref64

    cases = cases or mm_cases()
    operands = {label: (seeded((m, k), dt, device, 2 * i), seeded((k, n), dt, device, 2 * i + 1))
                for i, (label, m, k, n, dt) in enumerate(cases)}
    mm.COUNTER.reset()
    outs = {(label, comp): ops.matmul(*operands[label], compensated=comp)
            for label, *_ in cases for comp in (False, True)}
    torch.cuda.synchronize()
    launches, plain_calls = mm.COUNTER.launches, mm.COUNTER.plain_calls
    entries = dict(mm.COUNTER.entries)
    print(f"  path: ops.matmul over {len(cases)} shapes x 2 modes: {launches} kernel launches "
          f"({entries}), {plain_calls} plain calls")
    assert launches == 2 * len(cases) and plain_calls == 0, (launches, plain_calls)
    sms = gemm.sm_count(device.index or 0)
    joins = 2 * sum(gemm.workspace_numel(m, n, k, ops.matmul_block_k(k),
                                         gemm.plan_split(m, n, k, ops.matmul_block_k(k), sms)) > 0
                    for _, m, k, n, _ in cases)
    assert entries == {gemm.ENTRY: launches, **({gemm.JOIN: joins} if joins else {})}, entries
    print(f"{'case':>15} {'mode':>5} {'M':>7} {'K':>5} {'N':>5} {'split':>5} {'vs plain':>8} "
          f"{'vs f64':>7} {'rms/plain':>9} {'ms':>8} {'plain':>8} {'matmul':>8} {'bound':>8} "
          f"{'ffma bd':>8}  (gates in units)")
    worst, rows = 0.0, {}
    for label, m, k, n, dt in cases:
        a, b = operands[label]
        dn = dtype_name(dt)
        ref64 = matmul_ref64(a, b)
        bk = ops.matmul_block_k(k)
        atol = MM_ATOL[dn] * k ** 0.5
        a32, b32 = a.float(), b.float()  # bf16: the same exact products, summed in fp32
        lib = time_ms(lambda: torch.matmul(a32, b32))
        del a32, b32
        nbytes, flops = a.element_size() * (m * k + k * n) + 4.0 * m * n, 2.0 * m * n * k
        bnd, by = (bound_ms(nbytes, 3 * flops, "tf32") if dt == torch.float32
                   else bound_ms(nbytes, flops, dn))
        bnd_ffma, _ = bound_ms(nbytes, flops, "float32")
        split = gemm.plan_split(m, n, k, bk, sms)
        for comp in (False, True):
            got = outs[label, comp]
            want = mm.ntx_matmul_torch(a, b, block_k=bk, compensated=comp)
            u_plain = float(((got - want).abs() / (atol + MM_RTOL * want.abs())).max())
            u_ref = float(((got.double() - ref64).abs() / (atol + MM_RTOL * ref64.abs())).max())
            ratio = rms(got.double() - ref64) / max(rms(want.double() - ref64), 1e-300)
            same = torch.equal(got, ops.matmul(a, b, compensated=comp))
            ms = time_ms(lambda: ops.matmul(a, b, compensated=comp))
            plain = time_ms(lambda: mm.ntx_matmul_torch(a, b, block_k=bk, compensated=comp),
                            iters=5)
            mode = "comp" if comp else "plain"
            print(f"{label:>15} {mode:>5} {m:>7} {k:>5} {n:>5} {split:>5} {u_plain:>8.4f} "
                  f"{u_ref:>7.4f} {ratio:>9.4f} {ms:>8.4f} {plain:>8.4f} "
                  f"{(f'{lib:.4f}' if not comp else 'none'):>8} {bnd:>8.5f} {bnd_ffma:>8.5f}")
            worst = max(worst, max_abs(got, want))
            rows[label, comp] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                                 "library_ms": None if comp else lib, "bound_ffma_ms": bnd_ffma,
                                 "rms_ratio": ratio}
            assert bool(torch.isfinite(got).all()) and got.shape == (m, n), f"{label} {mode}"
            assert got.dtype == torch.float32, got.dtype
            assert u_plain <= 1, f"{label} {mode}: kernel vs plain {u_plain:.3f} of the band"
            assert ratio <= MM_RMS, f"{label} {mode}: RMS vs fp64 {ratio:.4f} x the plain's"
            assert same, f"{label} {mode}: two runs gave different bits"
        del ref64
    print(f"  bound at the rate of what the kernel computes on: fp32 operands as three tf32 "
          f"products (495 TFLOP/s), bf16 at 989; 'ffma bd' at the fp32-FFMA rate (67); "
          f"'matmul' is torch.matmul in fp32, TF32 off (bf16 operands widened first); "
          f"compensated mode has no library call; {ptxas_summary(gemm.LIB)}")

    ffma = {}
    for label in (lab for lab, *_ in cases if lab.startswith("L1 ")):
        a, b = operands[label]
        bk = ops.matmul_block_k(a.shape[1])
        got = mm.launch(mm.FFMA, a, b, block_k=bk)
        want = mm.ntx_matmul_torch(a, b, block_k=bk)
        u = float(((got - want).abs() / (MM_ATOL[dtype_name(a.dtype)] * a.shape[1] ** 0.5
                                         + MM_RTOL * want.abs())).max())
        ffma[label] = time_ms(lambda: mm.launch(mm.FFMA, a, b, block_k=bk))
        bt = b.T.contiguous().T  # B K-contiguous: 16-byte loads in place of element loads
        assert torch.equal(ops.matmul(a, bt), outs[label, False]), f"{label}: B view changed bits"
        bt_ms = time_ms(lambda: ops.matmul(a, bt))
        r = rows[label, False]
        print(f"  {label} plain mode: {gemm.ENTRY} {r['ms']:.4f} ms (B as a K-contiguous view, "
              f"same bits: {bt_ms:.4f} ms), FFMA entry {ffma[label]:.4f} ms (vs plain {u:.4f} "
              f"of the band), torch.matmul {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} "
              f"ms ({r['bound_by']}; fp32-FFMA rate {r['bound_ffma_ms']:.5f})")
        assert u <= 1, f"{label}: FFMA entry vs plain {u:.3f} of the band"
        del bt
    big = next(lab for lab, *_, dt in reversed(cases) if dt == torch.float32)
    a, b = operands[big]
    for comp in (False, True):
        forced = mm.launch(gemm.ENTRY, a, b, block_k=ops.matmul_block_k(a.shape[1]),
                           compensated=comp, split=4)
        assert torch.equal(forced, outs[big, comp]), f"{big}: split 4 changed the bits"
    planned = gemm.plan_split(a.shape[0], b.shape[1], a.shape[1], ops.matmul_block_k(a.shape[1]),
                              sms)
    print(f"  {big}: split 4 == split {planned} bit for bit, plain and compensated")
    check_mm_controls(operands, outs, cases)

    a16, b16 = (seeded((2, 2), torch.bfloat16, device, 0) for _ in range(2))
    out16 = ops.matmul(a16, b16, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16 and torch.equal(
        out16, mm.ntx_matmul_torch(a16, b16, block_k=2, out_dtype=torch.bfloat16))

    m, k, n = comp_shape
    print(f"  compensation gate: integers in [0, {COMP_HIGH}), M {m}, K {k}, N {n}, K tiles of "
          f"{ops.matmul_block_k(k)}; elements that differ from the fp64 product rounded once:")
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=device).manual_seed(3)
        a = torch.randint(0, COMP_HIGH, (m, k), generator=g, device=device).to(dt)
        b = torch.randint(0, COMP_HIGH, (k, n), generator=g, device=device).to(dt)
        exact = matmul_ref64(a, b)
        over = float((exact > 2.0 ** 24).double().mean())
        exact = exact.float()
        comp_k = ops.matmul(a, b, compensated=True)
        comp_p = mm.ntx_matmul_torch(a, b, block_k=ops.matmul_block_k(k), compensated=True)
        ctl = ops.matmul(a, b)
        n_k, n_p, n_ctl = (int((x != exact).sum()) for x in (comp_k, comp_p, ctl))
        print(f"    {dtype_name(dt)}: sums above 2**24 {over:.3f}; compensated kernel {n_k}, "
              f"compensated plain {n_p}, control (plain-mode kernel) {n_ctl} of {m * n}, max "
              f"{float((ctl - exact).abs().max()):.1f}: {'rejected' if n_ctl else 'passes'}")
        assert n_k == 0 and torch.equal(comp_k, comp_p), "compensated kernel is not exact"
        assert n_ctl > 0, "the compensation gate let the plain-mode control through"

    key = ("L1 float32", False)
    row = rows.get(key, rows[cases[0][0], False])
    bf16 = rows.get(("L1 bfloat16", False))
    smoke.kernels["ntx_matmul"] = {
        "name": "ntx_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ntx_gemm_wgmma.cu",
        "replaces": "src/repro/kernels/ntx_matmul.py:63",
        "launches": launches,
        "max_abs_err": worst,
        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "at": "GoogLeNet L1 im2col product, fp32, plain mode, via ops.matmul",
        "bound_ffma_ms": row["bound_ffma_ms"],
        "ffma_source": "src/repro_torch/kernels/csrc/ntx_matmul.cu",
        "ffma_ms": ffma.get("L1 float32"),
        **({"bf16_ms": bf16["ms"], "bf16_ffma_ms": ffma.get("L1 bfloat16"),
            "bf16_plain_ms": bf16["plain_ms"], "bf16_library_ms": bf16["library_ms"],
            "bf16_bound_ms": bf16["bound_ms"]} if bf16 else {}),
    }


def check_mm_controls(operands, outs, cases):
    """Lower-precision controls read through both ntx_matmul gates, on the
    fp32 L1 operands (the first fp32 case when L1 is not among them): the
    TF32 product (cuBLAS, TF32 on) and the 1xTF32 product of the kernel's
    own tiling (hi.hi alone, ``gemm_wgmma.emulate``) must be rejected by the
    band and by the RMS gate; the kernel's output rounded through bf16 must be
    rejected by the RMS gate. The band's rtol (1e-2) is wider than bf16
    rounding (2**-9), so its reading of that control is printed, not gated."""
    import torch

    from repro_torch.kernels import gemm_wgmma as gemm
    from repro_torch.kernels import ntx_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref64

    fp32 = [label for label, *_, dt in cases if dt == torch.float32]
    label = "L1 float32" if "L1 float32" in fp32 else fp32[0]
    a, b = operands[label]
    k = a.shape[1]
    bk = ops.matmul_block_k(k)
    atol = MM_ATOL["float32"] * k ** 0.5
    ref64 = matmul_ref64(a, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.matmul(a, b)
    finally:
        ops.strict_fp32()
    print(f"  controls on {label}, in units of the band (<= 1 passes) and of the plain "
          f"version's RMS error vs fp64 (<= {MM_RMS} passes):")
    for comp in (False, True):
        want = mm.ntx_matmul_torch(a, b, block_k=bk, compensated=comp)
        base = max(rms(want.double() - ref64), 1e-300)
        mode = "comp" if comp else "plain"
        one_tf32 = gemm.emulate(a, b, block_k=bk, compensated=comp, terms=1)
        for name, ctl in (("TF32 product", tf32), ("1xTF32 tiles", one_tf32),
                          ("kernel output via bf16", outs[label, comp].bfloat16().float())):
            band = float(((ctl - want).abs() / (atol + MM_RTOL * want.abs())).max())
            ratio = rms(ctl.double() - ref64) / base
            gated = "TF32" in name
            print(f"    {mode:>5} {name:>22}: band {band:.4f} "
                  f"({'rejected' if band > 1 else 'passes'}{'' if gated else ', not gated'}), "
                  f"RMS {ratio:.1f}x ({'rejected' if ratio > MM_RMS else 'passes'})")
            assert ratio > MM_RMS, f"{mode}: the RMS gate let the {name} control through"
            if gated:
                assert band > 1, f"{mode}: the band let the {name} control through"
        del one_tf32
    del ref64, tf32


def conv_cases(layers=GOOGLENET):
    """(label, layer, dtype): every layer in fp32 and in bf16."""
    import torch

    return [(f"{layer[0]} {dtype_name(dt)}", layer, dt)
            for dt in (torch.float32, torch.bfloat16) for layer in layers]


def conv_gate(got, want, dtype) -> float:
    """Error in units of the conv gate (<= 1 passes)."""
    import torch

    d = (got.double() - want.double()).abs()
    if dtype == torch.float32:
        return float((d / (CONV_F32["atol"] + CONV_F32["rtol"] * want.double().abs())).max())
    return float(d.max()) / (CONV_BF16 * float(want.double().abs().max()))


def control_conv_bf16_stages(x, w, stride: int):
    """The control of the rounded-once gate: the plain (u, v, ci) loop with
    its fp32 accumulator rounded to bf16 after every stage of at most 64
    input channels of one tap (after every tap where Cin <= 64). A 1 x 1 conv
    has one tap, so a rounding per tap alone would be the rounded-once
    result itself."""
    import torch

    kh, kw, cin, cout = w.shape
    n, h, wid, _ = x.shape
    oh, ow = (h - kh) // stride + 1, (wid - kw) // stride + 1
    xf, wf = x.float(), w.float()
    acc = torch.zeros((n, oh, ow, cout), dtype=torch.float32, device=x.device)
    for u in range(kh):
        for v in range(kw):
            xs = xf[:, u:u + (oh - 1) * stride + 1:stride, v:v + (ow - 1) * stride + 1:stride]
            for c0 in range(0, cin, 64):
                acc = (acc + xs[..., c0:c0 + 64] @ wf[u, v, c0:c0 + 64]).bfloat16().float()
    return acc.bfloat16()


def check_conv2d(smoke: Smoke, device, layers=GOOGLENET, batch: int = NTX_BATCH):
    """conv2d_ntx at the GoogLeNet layers vs conv2d_ntx_torch and an fp64 conv.

    First the path: every layer in fp32 and bf16 through ``conv2d_ntx``
    (inputs padded with F.pad; fp32 L0's a strided NHWC view of NCHW data),
    launch counts per C entry set to 0 just before and read just after: bf16
    with Cin and Cout multiples of 64 on the bf16 tensor-core entry, fp32
    with Cin a multiple of 32 and Cout of 64 on the 3xTF32 one, L0's Cin 3
    in both dtypes on the stem entry, none on the FFMA entry. Gates: kernel
    vs the plain version and vs the fp64 im2col conv at CONV_F32 /
    CONV_BF16, the same bits on a second run and at another tile_h, and fp32
    L0 on its strided input equal to L0 on a contiguous copy; bf16 also the
    rounded-once gate, fp32 on the 3xTF32 and stem entries also the RMS gate
    (MM_RMS). Controls: the fp32 kernel's output rounded through bf16, read
    through the fp32 band and the RMS gate, the 1xTF32 product (hi.hi
    alone), read through the RMS gate (the band's reading printed), and the
    conv that rounds to bf16 per stage, read through the rounded-once gate,
    must be rejected. Times: CUDA events over 20 calls (ms) and the kernels'
    device time under the profiler (dev ms); at L1 and at L0 the FFMA entry,
    called directly, is timed beside each tensor-core kernel. Bounds: fp32
    on the tensor cores at three tf32 products each (the fp32-FFMA rate's
    figure printed beside), bf16 at the bf16 rate.
    """
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import conv2d
    from repro_torch.kernels import conv2d_ntx_stem as stem
    from repro_torch.kernels import conv2d_ntx_tf32 as tf32
    from repro_torch.kernels import conv2d_ntx_wgmma as wgmma
    from repro_torch.kernels.ref import conv2d_ref, conv_rounded_once_share

    cases = conv_cases(layers)
    # the C entry of each case, and the module whose emulate(terms=1) is its
    # 1xTF32 control where it runs fp32 on the tensor cores
    entry_of = {label: conv2d.entry(dt, cin, cout, k, k, s)
                for label, (_, _, _, cin, k, s, _, cout), dt in cases}
    tf32_mods = {tf32.ENTRY: tf32, stem.ENTRY: stem}
    inputs = {}
    for i, (label, (name, h, w, cin, k, s, p, cout), dt) in enumerate(cases):
        if name == "L0" and dt == torch.float32:  # NCHW data, padded, viewed as NHWC
            x = F.pad(seeded((batch, cin, h, w), dt, device, 10 + i), (p, p, p, p))
            x = x.permute(0, 2, 3, 1)
        else:
            x = F.pad(seeded((batch, h, w, cin), dt, device, 10 + i), (0, 0, p, p, p, p))
        inputs[label] = (x, seeded((k, k, cin, cout), dt, device, 20 + i, 0.2), s)
    want_entries: dict[str, int] = {}
    for label, *_ in cases:
        e = entry_of[label]
        want_entries[e] = want_entries.get(e, 0) + 1
        if e == tf32.ENTRY:  # each call's first kernel splits w
            want_entries[tf32.SPLIT] = want_entries.get(tf32.SPLIT, 0) + 1
    conv2d.COUNTER.reset()
    outs = {label: conv2d.conv2d_ntx(x, wt, stride=s) for label, (x, wt, s) in inputs.items()}
    torch.cuda.synchronize()
    launches, plain_calls = conv2d.COUNTER.launches, conv2d.COUNTER.plain_calls
    entries = dict(conv2d.COUNTER.entries)
    print(f"  path: conv2d_ntx over {len(cases)} cases: {launches} kernel launches "
          f"({entries}), {plain_calls} plain calls")
    assert entries == want_entries and plain_calls == 0, (entries, want_entries, plain_calls)
    assert entries.get(wgmma.ENTRY, 0) == sum(
        wgmma.takes(dt, layer[3], layer[7]) for _, layer, dt in cases) > 0, entries
    assert entries.get(tf32.ENTRY, 0) == sum(
        tf32.takes(dt, layer[3], layer[7]) for _, layer, dt in cases) > 0, entries
    n_stem = sum(stem.takes(dt, layer[4], layer[4], layer[3], layer[7], layer[5])
                 for _, layer, dt in cases)
    assert entries.get(stem.ENTRY, 0) == n_stem, entries
    if n_stem:  # every layer on a tensor-core entry: none left on FFMA
        assert conv2d.FFMA not in entries, entries

    print(f"{'case':>12} {'out (N,OH,OW,C)':>20} {'vs plain':>8} {'vs f64':>7} {'control':>8} "
          f"{'ms':>8} {'dev ms':>8} {'plain':>8} {'conv2d':>8} {'dev':>8} {'bound':>8}  "
          f"(gates in units; bf16 control: rounded-once share)")
    worst, rows = 0.0, {}
    for label, (name, h, w, cin, k, s, p, cout), dt in cases:
        x, wt, s = inputs[label]
        y = outs[label]
        oh, ow = conv_geometry(h, w, k, s, p)
        want = conv2d.conv2d_ntx_torch(x, wt, stride=s)
        ref64 = conv2d_ref(x.double(), wt.double(), stride=s)
        u_plain, u_ref = conv_gate(y, want, dt), conv_gate(y, ref64, dt)
        rms_row = {}
        if dt == torch.float32 and entry_of[label] in tf32_mods:
            one = tf32_mods[entry_of[label]].emulate(x, wt, stride=s, terms=1)
            rms_row = {"kernel": rms_ratio(y, ref64, want), "1xTF32": rms_ratio(one, ref64, want),
                       "output via bf16": rms_ratio(y.bfloat16(), ref64, want)}
            print(f"{'':>12} {label} on {entry_of[label]}: RMS vs fp64 {rms_row['kernel']:.4f} x the "
                  f"plain version's (gate {MM_RMS}); controls: 1xTF32 {rms_row['1xTF32']:.1f}x, output "
                  f"via bf16 {rms_row['output via bf16']:.1f}x (both must be rejected); the band "
                  f"reads 1xTF32 at {conv_gate(one, want, dt):.2f}")
            del one
        del ref64
        assert y.shape == (batch, oh, ow, cout) and y.dtype == dt, (y.shape, y.dtype)
        assert bool(torch.isfinite(y).all()), f"{label}: non-finite output"
        assert torch.equal(y, conv2d.conv2d_ntx(x, wt, stride=s)), f"{label}: runs differ"
        assert torch.equal(y, conv2d.conv2d_ntx(x, wt, stride=s, tile_h=3)), \
            f"{label}: tile_h 8 and 3 gave different bits"
        if not x.is_contiguous():
            assert torch.equal(y, conv2d.conv2d_ntx(x.contiguous(), wt, stride=s)), \
                f"{label}: strided and contiguous input gave different bits"
        row = {}
        if dt == torch.float32:
            ctl = conv_gate(y.bfloat16(), want, torch.float32)
            ctl_text = f"{ctl:.2f}"
        else:
            row["rounded_once"] = share = conv_rounded_once_share(y, x, wt, s)
            plain_share = conv_rounded_once_share(want, x, wt, s)
            control = control_conv_bf16_stages(x, wt, s)
            ctl = conv_rounded_once_share(control, x, wt, s)
            band = conv_gate(control, want, dt)
            ctl_text = f"{ctl:.2%}"
            print(f"{'':>12} {entry_of[label]}: rounded-once share {share:.4%} "
                  f"(gate {ROUNDED_ONCE:.0%}), plain version {plain_share:.4%}; control "
                  f"(bf16 per stage) {ctl:.4%}, "
                  f"{'rejected' if ctl > ROUNDED_ONCE else 'passes'}; the 1e-2 band reads "
                  f"the control at {band:.4f} ({'rejected' if band > 1 else 'passes'})")
            del control
        xc = x.contiguous()
        ms = time_ms(lambda: conv2d.conv2d_ntx(x, wt, stride=s))
        dev = device_ms(lambda: conv2d.conv2d_ntx(x, wt, stride=s))
        plain = time_ms(lambda: conv2d.conv2d_ntx_torch(x, wt, stride=s), iters=5)
        x_cl, w_oihw = xc.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)  # channels-last NCHW
        lib = time_ms(lambda: F.conv2d(x_cl, w_oihw, stride=s))
        lib_dev = device_ms(lambda: F.conv2d(x_cl, w_oihw, stride=s))
        es = x.element_size()
        nbytes = es * (x.numel() + wt.numel() + y.numel())
        flops = 2.0 * batch * oh * ow * cout * k * k * cin
        bnd, by = (bound_ms(nbytes, 3 * flops, "tf32") if rms_row
                   else bound_ms(nbytes, flops, dtype_name(dt)))
        print(f"{label:>12} {str((batch, oh, ow, cout)):>20} {u_plain:>8.4f} {u_ref:>7.4f} "
              f"{ctl_text:>8} {ms:>8.4f} {dev:>8.4f} {plain:>8.4f} {lib:>8.4f} {lib_dev:>8.4f} "
              f"{bnd:>8.5f}")
        worst = max(worst, max_abs(y, want))
        rows[label] = {"ms": ms, "device_ms": dev, "plain_ms": plain, "library_ms": lib,
                       "library_device_ms": lib_dev, "bound_ms": bnd, "bound_by": by,
                       "bound_ffma_ms": bound_ms(nbytes, flops, "float32")[0], **row}
        assert u_plain <= 1 and u_ref <= 1, \
            f"{label}: kernel vs plain {u_plain:.3f}, vs fp64 {u_ref:.3f} of the gate"
        if rms_row:
            rows[label]["rms_ratio"] = rms_row["kernel"]
            assert rms_row.pop("kernel") <= MM_RMS, f"{label}: RMS vs fp64 over the plain's"
            for kind, r in rms_row.items():
                assert r > MM_RMS, f"{label}: the RMS gate let the {kind} control through"
        if dt == torch.float32:
            assert ctl > 1, f"{label}: the fp32 gate let the bf16-rounded control through"
        else:
            assert share <= ROUNDED_ONCE, f"{label}: rounded-once share {share:.4%}"
            assert ctl > ROUNDED_ONCE, f"{label}: the rounded-once gate let the control through"
    print("  run == run, tile_h 8 == tile_h 3 and strided L0 == contiguous L0: identical "
          "bits; controls rejected (fp32: output rounded to bf16, and on the 3xTF32 and stem "
          "entries 1xTF32; bf16: sums rounded to bf16 per stage); 'conv2d' is F.conv2d on the "
          "NHWC tensors as channels-last NCHW, cuDNN TF32 off; 'dev' columns: device time "
          "under torch.profiler; 'bound' for fp32 on the tensor cores at 495 TFLOP/s")
    l1_32 = next((lab for lab, layer, dt in cases if dt == torch.float32
                  and tf32.takes(dt, layer[3], layer[7])), None)
    f32_row = {}
    if l1_32 is not None:  # the FFMA fp32 entry beside the 3xTF32 kernel
        x, wt, s = inputs[l1_32]
        ffma = conv2d.launch(conv2d.FFMA, x, wt, stride=s)
        u_ffma = conv_gate(ffma, conv2d.conv2d_ntx_torch(x, wt, stride=s), torch.float32)
        assert u_ffma <= 1, f"{l1_32}: FFMA fp32 entry vs plain {u_ffma:.3f} of the gate"
        ffma32_ms = time_ms(lambda: conv2d.launch(conv2d.FFMA, x, wt, stride=s))
        # a call is two kernels: the split of w, then the conv
        by_kernel = kernel_ms(lambda: conv2d.conv2d_ntx(x, wt, stride=s))
        split_dev = sum(t for name, t in by_kernel.items() if "split_w_kernel" in name)
        conv_dev = sum(t for name, t in by_kernel.items() if "conv_tf32_kernel" in name)
        r = rows[l1_32]
        print(f"  {l1_32}: {tf32.ENTRY} {r['ms']:.4f} ms (device {r['device_ms']:.4f}: "
              f"split_w_kernel {split_dev:.4f}, conv_tf32_kernel {conv_dev:.4f}; "
              f"{entries[tf32.SPLIT]} split launches in the path run), FFMA fp32 "
              f"entry {ffma32_ms:.4f} ms (vs plain {u_ffma:.3f} of the gate), cuDNN fp32 "
              f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}; at the "
              f"fp32-FFMA rate {r['bound_ffma_ms']:.5f}); {ptxas_summary(tf32.LIB)}")
        f32_row = {
            "f32_source": "src/repro_torch/kernels/csrc/conv2d_ntx_tf32.cu",
            "f32_ms": r["ms"],
            "f32_device_ms": None if math.isnan(r["device_ms"]) else r["device_ms"],
            "f32_split_launches": entries[tf32.SPLIT],
            "f32_split_device_ms": split_dev if by_kernel else None,
            "f32_conv_device_ms": conv_dev if by_kernel else None,
            "f32_ffma_ms": ffma32_ms,
            "f32_plain_ms": r["plain_ms"],
            "f32_library_ms": r["library_ms"],
            "f32_bound_ms": r["bound_ms"],
            "f32_rms_ratio": {lab: rows[lab]["rms_ratio"] for lab in rows
                              if "rms_ratio" in rows[lab]},
            "f32_at": f"GoogLeNet {l1_32.split()[0]} at batch {batch}, fp32",
        }

    l1 = next((lab for lab, layer, dt in cases if dt == torch.bfloat16
               and wgmma.takes(dt, layer[3], layer[7])), None)
    bf16_row = {}
    if l1 is not None:  # the FFMA bf16 entry beside the tensor-core kernel
        x, wt, s = inputs[l1]
        ffma = conv2d.launch(conv2d.FFMA, x, wt, stride=s)
        u_ffma = conv_gate(ffma, conv2d.conv2d_ntx_torch(x, wt, stride=s), torch.bfloat16)
        assert u_ffma <= 1, f"{l1}: FFMA bf16 entry vs plain {u_ffma:.3f} of the gate"
        ffma_ms = time_ms(lambda: conv2d.launch(conv2d.FFMA, x, wt, stride=s))
        r = rows[l1]
        print(f"  {l1}: {wgmma.ENTRY} {r['ms']:.4f} ms (device {r['device_ms']:.4f}), FFMA bf16 "
              f"entry {ffma_ms:.4f} ms (vs plain {u_ffma:.3f} of the gate), cuDNN bf16 "
              f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
        bf16_row = {
            "bf16_source": "src/repro_torch/kernels/csrc/conv2d_ntx_wgmma.cu",
            "bf16_ms": r["ms"],
            "bf16_device_ms": None if math.isnan(r["device_ms"]) else r["device_ms"],
            "bf16_ffma_ms": ffma_ms,
            "bf16_plain_ms": r["plain_ms"],
            "bf16_library_ms": r["library_ms"],
            "bf16_bound_ms": r["bound_ms"],
            "bf16_rounded_once": r["rounded_once"],
            "bf16_at": f"GoogLeNet {l1.split()[0]} at batch {batch}, bf16",
        }
    stem_row = {}
    for label, (name, *_), dt in cases:  # the FFMA entry beside the stem kernel
        if entry_of[label] != stem.ENTRY:
            continue
        x, wt, s = inputs[label]
        ffma = conv2d.launch(conv2d.FFMA, x, wt, stride=s)
        u_ffma = conv_gate(ffma, conv2d.conv2d_ntx_torch(x, wt, stride=s), dt)
        del ffma
        assert u_ffma <= 1, f"{label}: FFMA entry vs plain {u_ffma:.3f} of the gate"
        ffma_ms = time_ms(lambda: conv2d.launch(conv2d.FFMA, x, wt, stride=s))
        r, key = rows[label], f"stem_{dtype_name(dt)}"
        print(f"  {label}: {stem.ENTRY} {r['ms']:.4f} ms (device {r['device_ms']:.4f}), FFMA "
              f"entry {ffma_ms:.4f} ms (vs plain {u_ffma:.3f} of the gate), cuDNN "
              f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}"
              f"{'; at the fp32-FFMA rate %.5f' % r['bound_ffma_ms'] if 'rms_ratio' in r else ''})"
              f"; {ptxas_summary(stem.LIB)}")
        stem_row.update({
            f"{key}_ms": r["ms"],
            f"{key}_device_ms": None if math.isnan(r["device_ms"]) else r["device_ms"],
            f"{key}_ffma_ms": ffma_ms,
            f"{key}_plain_ms": r["plain_ms"],
            f"{key}_library_ms": r["library_ms"],
            f"{key}_library_device_ms": r["library_device_ms"],
            f"{key}_bound_ms": r["bound_ms"],
            f"{key}_bound_by": r["bound_by"],
            **({f"{key}_rms_ratio": r["rms_ratio"]} if "rms_ratio" in r else
               {f"{key}_rounded_once": r.get("rounded_once")}),
        })
    if stem_row:
        stem_row["stem_source"] = "src/repro_torch/kernels/csrc/conv2d_ntx_stem.cu"
        stem_row["stem_at"] = f"GoogLeNet L0 at batch {batch}"
    lab32 = "L1 float32" if "L1 float32" in rows else cases[0][0]
    fp32 = rows[lab32]
    lib32 = conv2d.ENTRIES[entry_of[lab32]]
    smoke.kernels["conv2d_ntx"] = {
        "name": "conv2d_ntx",
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{lib32}.cu",
        "replaces": "src/repro/kernels/conv2d.py:53",
        "launches": launches,
        "launches_by_entry": entries,
        "max_abs_err": worst,
        **{key: fp32[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "at": "GoogLeNet L1 at batch 32, fp32",
        **f32_row,
        **bf16_row,
        **stem_row,
    }


def check_c5(device):
    """ROADMAP C5: fp32 sums too short for 3xTF32 go to the FFMA entries. The
    conv at 3 x 3 x 3 (K 27), 3 x 3 x 5 (K 45) and 1 x 1 x 32, and attention
    with a window of 32 keys on a 2,048-token call: each routed to FFMA and
    held by the RMS gate (RMS error against fp64 at most MM_RMS x the plain
    version's); the 1xTF32 control must fail it; the tensor-core entry that
    the route avoids is read beside it, forced by name."""
    import torch

    from repro_torch.kernels import conv2d
    from repro_torch.kernels import conv2d_ntx_stem as stem
    from repro_torch.kernels import conv2d_ntx_tf32 as conv_tf32
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_tf32 as attn_tf32
    from repro_torch.kernels.ref import attention_ref, conv2d_ref

    readings = {}
    for label, (n, hw, cin, k, cout), tc in (
            ("conv K 27 (3 x 3 x 3)", (8, 58, 3, 3, 64), stem),
            ("conv K 45 (3 x 3 x 5)", (8, 58, 5, 3, 64), stem),
            ("conv 1 x 1 x 32", (8, 56, 32, 1, 64), conv_tf32)):
        x = seeded((n, hw, hw, cin), torch.float32, device, seed=cin + k)
        w = seeded((k, k, cin, cout), torch.float32, device, seed=cin + k + 1, scale=0.2)
        entry = conv2d.entry(torch.float32, cin, cout, k, k, 1)
        conv2d.COUNTER.reset()
        y = conv2d.conv2d_ntx(x, w)
        torch.cuda.synchronize()
        assert entry == conv2d.FFMA and conv2d.COUNTER.entries == {entry: 1}, (
            label, entry, conv2d.COUNTER.entries)
        plain = conv2d.conv2d_ntx_torch(x, w)
        ref64 = conv2d_ref(x.double(), w.double())
        r = rms_ratio(y, ref64, plain)
        forced = rms_ratio(conv2d.launch(tc.ENTRY, x, w), ref64, plain)
        one = rms_ratio(tc.emulate(x, w, terms=1), ref64, plain)
        readings[label] = (r, forced, one)
        del x, w, y, plain, ref64
    q, k, v = attention_inputs(1, 16, 16, QWEN_SEQ, QWEN_SEQ, 64, torch.float32, device, 7)
    kw = {"causal": True, "window": 32}
    entry = fa.entry(torch.float32, 64, 32)
    fa.COUNTER.reset()
    o = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert entry == "flash_attention_f32" and fa.COUNTER.entries == {entry: 1}, fa.COUNTER.entries
    plain = fa.flash_attention_torch(q, k, v, **kw)
    ref64 = attention_ref(q, k, v, compute_dtype=torch.float64, **kw)
    forced = fa.launch(attn_tf32.ENTRY, q, k, v, **kw)
    readings["attention window 32"] = (
        rms_ratio(o, ref64, plain), rms_ratio(forced, ref64, plain),
        rms_ratio(attn_tf32.emulate(q, k, v, terms=1, **kw), ref64, plain))
    for label, (r, forced, one) in readings.items():
        print(f"  {label}: FFMA entry, RMS vs fp64 {r:.4f} x the plain version's (gate {MM_RMS}); "
              f"the 3xTF32 entry forced {forced:.4f}; 1xTF32 control {one:.1f} "
              f"({'rejected' if one > MM_RMS else 'passes'})")
        assert r <= MM_RMS, f"{label}: RMS vs fp64 {r:.4f} x the plain version's"
        assert one > MM_RMS, f"the {label} RMS gate let the 1xTF32 control through"
    return readings


# the band of tests/test_torch_train.py between the command interpreter and
# the region kernel (fp64-accumulated vs fp32 sums in another order)
REF_BAND = {"rtol": 2e-3, "atol": 1e-5}


def program_work(program) -> tuple[float, float]:
    """Bytes (the step's inputs read once, its outputs written once) and
    operations of one NTX program: two per ``mac`` iteration (multiply and
    add), one per iteration of every other opcode."""
    import math

    nbytes = sum(r.bytes for r in program.regions.values()
                 if r.kind in ("input", "param", "output"))
    ops = sum(math.prod(b.template.loops) * b.n_commands
              * (2 if b.template.opcode == "mac" else 1) for b in program.blocks)
    return float(nbytes), float(ops)


def ntx_time_by_step(prog, step) -> dict[str, float]:
    """Device ms of one run of ``step`` per schedule step of ``prog`` (block
    tags cut to ``node:pass``; spill / fill and constant blocks under their
    own tags): the kernel launches read from a torch.profiler trace in
    issue order, one per command. Empty where the profiler sees no launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    runs = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "ntx_exec_kernel" in e.name)
    if len(runs) != prog.n_commands:
        return {}
    per, i = {}, 0
    for b in prog.blocks:
        key = ":".join(b.tag.split(":")[:2])
        per[key] = per.get(key, 0.0) + sum(us for _, us in runs[i:i + b.n_commands]) / 1e3
        i += b.n_commands
    return per


def ntx_program_path(smoke: Smoke, device, steps: int = STEPS):
    """The NTX command path: the paper CNN's training step lowered to one
    NtxProgram (lower_training_step) and run command by command on the
    command kernel (ntx_exec, one launch per command) through
    train_graph(backend="reference").

    One step on one set of inputs against the plain interpreter (on the
    host's CPU): logits bit-identical, every other output within TOL (vexp),
    the same bits run to run; the narrow accumulator (wide=False) is the
    control, its logits must differ from the wide plain version's. Then
    ``steps`` reference steps (counts set to 0 just before, read just
    after: every command one launch, none on the plain version) against the
    fused run_torch step on the region kernel at REF_BAND. Then the matmul
    and conv templates on the command kernel against B2's, B5's and B6's
    kernels at the main path's fc and c2 shapes.
    """
    import numpy as np
    import torch

    from repro_torch.core.ntx import ntx_execute
    from repro_torch.kernels import conv2d, ntx_exec, ops, streaming
    from repro_torch.lower import (frequency_band_batches, lower_training_step, run_reference,
                                   train_graph)
    from repro_torch.lower.rules import conv2d_fwd_template, matmul_template

    graph, inputs = main_path_graph_inputs(device)
    batch, img = graph.batch, graph.input_shape[0]
    t0 = time.perf_counter()
    prog = lower_training_step(graph)
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = ntx_exec.program_table(prog)
    t_plan = time.perf_counter() - t0
    print(f"  ntx train-step program: {len(prog.blocks)} blocks, {prog.n_commands} commands, "
          f"peak TCDM {prog.meta['peak_tcdm_bytes']} / {prog.meta['tcdm_budget_bytes']} B "
          f"({len(prog.meta['spilled'])} spilled); lowered in {t_lower:.3f} s, modes "
          f"planned in {t_plan:.3f} s: {table['per_mode']}")
    logits = graph.logits_edge

    # one step: the kernel against the plain interpreter on the host
    cpu_inputs = {k: v.cpu() for k, v in inputs.items()}
    ntx_exec.COUNTER.reset()
    t0 = time.perf_counter()
    got = run_reference(prog, inputs, device=device)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    again = run_reference(prog, inputs, device=device)
    narrow = run_reference(prog, inputs, wide=False, device=device)
    torch.cuda.synchronize()
    assert ntx_exec.COUNTER.plain_calls == 0
    t0 = time.perf_counter()
    want = run_reference(prog, cpu_inputs, device="cpu")
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert set(got) == set(want)
    worst = max(max_abs(got[k].cpu(), want[k]) for k in want)
    same = torch.equal(got[logits].cpu(), want[logits])
    print(f"  one step at batch {batch}: kernel vs plain interpreter (CPU, {plain_ms:.0f} ms): "
          f"logits bit-identical {same}; max_abs over all outputs {worst:.3e}; first kernel "
          f"step {t_first * 1e3:.1f} ms (device table upload included)")
    assert same, f"logits differ from the plain interpreter: {max_abs(got[logits].cpu(), want[logits]):.3e}"
    for k, v in want.items():
        torch.testing.assert_close(got[k].cpu(), v, **TOL, msg=f"kernel vs plain {k}")
        assert torch.equal(got[k], again[k]), f"{k}: two runs gave different bits"
    ctl = max_abs(narrow[logits].cpu(), want[logits])
    print(f"  control wide=False: logits max_abs {ctl:.3e} from the wide plain version, "
          f"{'rejected' if ctl > 0 else 'passes'} by the bit-identity gate")
    assert ctl > 0, "the logits bit-identity gate let the narrow accumulator through"

    # the main path: `steps` reference steps on the kernel, against the fused step
    batch_fn = frequency_band_batches(np.random.RandomState(0), batch, img, graph.loss.classes)
    params = graph.init_params(seed=0)
    ntx_exec.COUNTER.reset()
    ref = train_graph(graph, steps, batch_fn, backend="reference", program=prog,
                      params=params, device=device)
    counts = (ntx_exec.COUNTER.launches, ntx_exec.COUNTER.plain_calls)
    per_mode = dict(ntx_exec.COUNTER.entries)
    print(f"  {steps} reference steps: ntx_exec launches / plain calls {counts}, by mode "
          f"{per_mode}; losses {[round(x, 5) for x in ref['losses']]}")
    assert counts == (steps * prog.n_commands, 0), counts
    assert per_mode == {m: steps * n for m, n in table["per_mode"].items() if n}, per_mode
    assert ref["losses"][-1] < ref["losses"][0], ref["losses"]
    fused = train_graph(graph, steps, frequency_band_batches(
        np.random.RandomState(0), batch, img, graph.loss.classes),
        params=params, device=device)
    r0, f0 = ref["first_outputs"], fused["first_outputs"]
    assert set(r0) == set(f0)

    def units(k) -> float:
        d = (f0[k].double() - r0[k].double()).abs()
        return float((d / (REF_BAND["atol"] + REF_BAND["rtol"] * r0[k].double().abs())).max())

    far = max(r0, key=units)
    print(f"  step 0, fused run_torch (region kernel) vs the reference step: worst {far} at "
          f"{units(far):.4f} of rtol {REF_BAND['rtol']} / atol {REF_BAND['atol']}; losses "
          f"fused {[round(x, 5) for x in fused['losses']]}")
    for k in r0:
        torch.testing.assert_close(f0[k], r0[k], **REF_BAND, msg=f"fused vs reference {k}")
    np.testing.assert_allclose(fused["losses"], ref["losses"], rtol=REF_BAND["rtol"])
    walls = ref["walls"][1:]
    wall = sum(walls) / len(walls) * 1e3

    # time: one step, by events and by the profiler's device time
    step = lambda: run_reference(prog, inputs, device=device)  # noqa: E731
    ms = time_ms(step, iters=3, warmup=1)
    dev_ms = device_ms(step, iters=2)
    nbytes, nops = program_work(prog)
    bnd, by = bound_ms(nbytes, nops)
    _, card = device_info()
    print(f"  on {card}: reference step at batch {batch}: {ms:.3f} ms by events, {dev_ms:.3f} ms of "
          f"ntx_exec device time ({dev_ms / ms:.1%} of it), warm step wall {wall:.3f} ms "
          f"(host clock, synchronised, mean of {len(walls)}); plain interpreter {plain_ms:.0f} "
          f"ms on the host's CPU; bound {bnd:.5f} ms ({nbytes / 1e6:.3f} MB, "
          f"{nops / 1e6:.1f} M operations at the fp32 rate, {by}); {ptxas_summary('ntx_exec')}")

    per_step = ntx_time_by_step(prog, step)
    if per_step:
        top = sorted(per_step.items(), key=lambda kv: -kv[1])
        print(f"  device ms by schedule step ({sum(per_step.values()):.3f} ms in "
              f"{prog.n_commands} launches): " + ", ".join(f"{k} {v:.3f}" for k, v in top[:12])
              + f"; the other {len(top) - 12} steps {sum(v for _, v in top[12:]):.3f}")
    else:
        print("  device ms by schedule step: the profiler saw no launch per command")

    # the templates against B2, B5 and B6 on the card, at the main path's shapes
    m, n, k = batch, graph.loss.classes, 512  # the fc forward
    a = seeded((m, k), torch.float32, device, seed=21)
    b = seeded((k, n), torch.float32, device, seed=22)
    mem = torch.zeros(m * k + k * n + m * n, device=device)
    mem[: m * k] = a.reshape(-1)
    mem[m * k: m * k + k * n] = b.reshape(-1)
    ntx_exec.COUNTER.reset()
    ntx_execute(matmul_template(m, n, k, 0, m * k, m * k + k * n), mem, inplace=True)
    c = mem[m * k + k * n:].reshape(m, n)
    for label, kernel in (("B5 ops.matmul", ops.matmul(a, b)),
                          ("B2 streaming_matmul", streaming.streaming_matmul(a, b))):
        err = max_abs(c, kernel)
        print(f"  matmul template ({m} x {n} x {k}) vs {label}: max_abs {err:.3e}")
        torch.testing.assert_close(c, kernel, rtol=1e-5, atol=1e-5, msg=label)
    x = seeded((1, 18, 18, 16), torch.float32, device, seed=23)  # c2's padded plane
    w = seeded((3, 3, 16, 32), torch.float32, device, seed=24, scale=0.2)
    cmem = torch.zeros(x.numel() + w.numel() + 8 * 8 * 32, device=device)
    cmem[: x.numel()] = x.reshape(-1)
    cmem[x.numel(): x.numel() + w.numel()] = w.reshape(-1)
    y0 = x.numel() + w.numel()
    for co in range(32):  # one command per output channel
        ntx_execute(conv2d_fwd_template(18, 18, 16, 3, 3, 32, 0, x.numel() + co, y0 + co,
                                        stride=2), cmem, inplace=True)
    y = cmem[y0:].reshape(1, 8, 8, 32)
    yk = conv2d.conv2d_ntx(x, w, stride=2)
    torch.cuda.synchronize()
    print(f"  conv template (c2: 18 x 18 x 16, 3 x 3, stride 2, 32 out) vs B6 conv2d_ntx: "
          f"max_abs {max_abs(y, yk):.3e}; template launches {ntx_exec.COUNTER.launches}")
    torch.testing.assert_close(y, yk, **CONV_F32, msg="conv template vs B6")
    assert ntx_exec.COUNTER.launches == 33 and ntx_exec.COUNTER.plain_calls == 0

    smoke.kernels["ntx_exec"] = {
        "name": "ntx_exec",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ntx_exec.cu",
        "replaces": "none: the JAX package's numpy interpreter, src/repro/core/ntx.py:117",
        "launches": counts[0],
        "launches_by_mode": per_mode,
        "max_abs_err": worst,
        "ms": ms,
        "device_ms": dev_ms,
        "plain_ms": plain_ms,
        "plain_device": "cpu",
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": None,
        "at": f"one paper-CNN training step, batch {batch}, img {img}, {prog.n_commands} "
              f"commands",
        "step_wall_ms": wall,
        "narrow_control_max_abs": ctl,
        "device_ms_by_step": per_step,
    }


# The JAX package's lower_training_step + run_timing(n_clusters=16) of the
# main path's step program (paper CNN, batch 64, img 32): outputs of the NTX
# cycle model, not times on any chip. The block engine materialises at most
# 50,000 records and elides the rest; the event engine keeps them all.
MODEL_TOTALS = {"offloads": 10_847, "staging_offloads": 759, "commands": 11_606,
                "busy_cycles": 106_731_647, "dma_bytes": 77_215_656}
MODEL_SUMMARY = {"clusters": 16, "total_cycles": 2_420_531, "queue_depth": 4,
                 "n_commands": 11_606, "dma_stall_cycles": 5_212_941,
                 "queue_stall_cycles": 22_654_386, "overhead_cycles": 7_558_537}
MODEL_UTILIZATION = 0.34449
MODEL_ELIDED = {"event": 0, "block": 3_472}
F_NTX = 1.5e9  # the NTX clock of the cycle model


def check_metrics(path, res) -> dict:
    """The metrics JSONL of one instrumented run: one record per step, each
    with the program's closed-form totals and the fusion plan's counters."""
    from repro_torch import obs

    recs = obs.read_jsonl(path)
    assert [r["step"] for r in recs] == list(range(STEPS)), [r["step"] for r in recs]
    totals = obs.program_totals(res["program"])
    fusion = res["fusion"]
    want_fusion = {"regions": fusion.n_regions,
                   "fallback_dispatches": len(fusion.fallback_steps),
                   "fused_commands": fusion.fused_commands,
                   "unfused_commands": fusion.total_commands - fusion.fused_commands}
    for r in recs:
        c = r["counters"]
        assert {k: c.get(k) for k in totals} == totals, (r["step"], c)
        assert {k: c.get(k) for k in want_fusion} == want_fusion, (r["step"], c)
        assert r["loss"] == res["losses"][r["step"]]
    calls = sum(r["counters"]["calls"] for r in recs)
    assert calls == res["cache"].calls, (calls, res["cache"].calls)
    return recs[-1]["counters"]


def check_trace(path, res) -> dict:
    """The merged trace of one instrumented run: one lowering span per
    emitting step, one dispatch span per plan call, hmc0 exec and DMA lanes,
    flow events."""
    doc = json.loads(Path(path).read_text())
    evs = doc["traceEvents"]
    prog = res["program"]
    steps = set(prog.meta["steps"])
    names = [e["name"][len("lower:"):] for e in evs if e.get("cat") == "lowering"]
    emitted = {":".join(b.tag.split(":")[:2]) for b in prog.blocks} & steps
    assert len(names) == len(set(names)), "a step was lowered twice"
    assert emitted <= set(names) <= steps, (emitted - set(names), set(names) - steps)
    spans = [e for e in evs if e.get("cat") in ("fused", "dispatch")]
    assert len(spans) == res["cache"].calls, (len(spans), res["cache"].calls)
    assert all(e["pid"] == "host" and e["tid"] == "dispatch" for e in spans)
    lanes = {(e["cat"], e["tid"]) for e in evs if e["pid"] == "hmc0" and e["ph"] == "X"}
    assert {c for c, _ in lanes} == {"exec", "dma"}, lanes
    n_clusters = prog.meta["n_clusters"]
    assert {t for c, t in lanes if c == "exec"} == {f"cluster{c}" for c in range(n_clusters)}
    flows = {e["ph"] for e in evs if e.get("cat") == "flow"}
    assert flows >= {"s", "f"}, flows
    cats = {}
    for e in evs:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    return {"events": len(evs), "by_cat": cats, "lowering_spans": len(names),
            "plan_call_spans": len(spans), "span_names": sorted({e["name"] for e in spans})}


def booking_ms(res, reps: int = 40) -> float:
    """Host ms of what an instrumented fused step books inside its wall: the
    step scope, the program's digest, the plan-cache delta, the fusion
    counters and one host span; five steps into a fresh registry a rep."""
    from repro_torch import obs
    from repro_torch.lower import executors

    program, cache, fusion = res["program"], res["cache"], res["fusion"]
    col = obs.TraceCollector()
    t0 = time.perf_counter()
    for _ in range(reps):
        reg = obs.CounterRegistry()
        for i in range(STEPS):
            before = (cache.hits, cache.misses, cache.calls)
            with reg.scope(f"step{i}"), col.host_span("region", cat="fused"):
                obs.record_program(reg, program)
                executors._record_cache_delta(reg, cache, before)
                executors._record_fusion(reg, fusion)
    return (time.perf_counter() - t0) * 1e3 / (reps * STEPS)


def obs_and_timing(device):
    """The obs layer and the NTX timing model on the main path.

    run_ntx_cnn at the main path's width, fused, eight times: plain,
    instrumented (--metrics, --trace), instrumented, plain, twice. Losses
    must be bit-identical across the eight, every run one region launch a
    step and no plain call; each metrics record carries the program's
    closed-form totals and the fusion plan's counters; each trace has its
    lowering, dispatch and hmc0 lanes. The host cost of what an
    instrumented step books is timed apart. Then run_timing on the step
    program, on both engines, against the JAX package's figures, and one
    reference step (the command kernel) under a registry against the
    closed form.
    """
    import tempfile

    import numpy as np

    from repro_torch import obs
    from repro_torch.kernels import fused, ntx_exec, streaming
    from repro_torch.launch.train import run_ntx_cnn
    from repro_torch.lower import frequency_band_batches, run_timing, train_graph

    counters = (fused.COUNTER, streaming.COUNTER)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, instrumented in enumerate((False, True, True, False) * 2):
            for c in counters:
                c.reset()
            files = (dict(metrics=f"{tmp}/m{k}.jsonl", trace=f"{tmp}/t{k}.json")
                     if instrumented else {})
            res = run_ntx_cnn(STEPS, BATCH, IMG, device=device, **files)
            counts = {c.name: (c.launches, c.plain_calls) for c in counters}
            assert counts["fused_region"] == (STEPS, 0), counts
            assert counts["streaming_matmul"][1] == 0, counts
            info = {}
            if instrumented:
                info["counters"] = check_metrics(files["metrics"], res)
                info["trace"] = check_trace(files["trace"], res)
            walls = res["walls"][1:]
            runs.append((instrumented, res, counts, sum(walls) / len(walls) * 1e3, info))
    base = runs[0][1]
    for instrumented, res, counts, wall, _ in runs:
        assert res["losses"] == base["losses"], (instrumented, res["losses"], base["losses"])
        assert counts == runs[0][2], (counts, runs[0][2])
    info = runs[1][4]
    print(f"  {len(runs)} runs (plain, instrumented, instrumented, plain, twice): losses "
          f"bit-identical "
          f"{[round(x, 6) for x in base['losses']]}; launches / plain calls {runs[0][2]} "
          f"in every run")
    print(f"  step counters (last record): {info['counters']}")
    print(f"  trace: {info['trace']}")
    _, card = device_info()
    mean = {i: sum(r[3] for r in runs if r[0] == i) / (len(runs) / 2) for i in (False, True)}
    print(f"  on {card}: warm fused step wall (host clock, synchronised, mean of steps 1-"
          f"{STEPS - 1}), ms: " + ", ".join(
              f"{'instrumented' if r[0] else 'plain'} {r[3]:.3f}" for r in runs)
          + f"; means plain {mean[False]:.3f}, instrumented {mean[True]:.3f}")
    print(f"  host booking of one instrumented step, apart: {booking_ms(base):.4f} ms "
          f"(the card machine's CPU)")

    # the NTX timing model on the step program, both engines
    program = base["program"]
    assert obs.program_totals(program) == MODEL_TOTALS, obs.program_totals(program)
    for engine in ("event", "block"):
        t0 = time.perf_counter()
        result = run_timing(program, n_clusters=16, engine=engine)
        host_s = time.perf_counter() - t0
        s = result.summary()
        print(f"  run_timing engine={engine}: {s}; exec_cycles {result.exec_cycles}; "
              f"{host_s:.3f} s of host wall on the card machine's CPU")
        assert {k: s[k] for k in MODEL_SUMMARY} == MODEL_SUMMARY, s
        assert s["elided_commands"] == MODEL_ELIDED[engine], s
        assert round(s["utilization"], 5) == MODEL_UTILIZATION, s
        assert result.exec_cycles == MODEL_TOTALS["busy_cycles"]
    print(f"  modeled step (NTX cycle model, {F_NTX / 1e9:.1f} GHz, 16 clusters; not a time "
          f"on any chip): {MODEL_SUMMARY['total_cycles']} cycles = "
          f"{MODEL_SUMMARY['total_cycles'] / F_NTX * 1e3:.6f} ms, utilization "
          f"{MODEL_UTILIZATION}")

    # the reference path under a registry: one step on the command kernel
    graph = program.meta["graph"]
    reg = obs.CounterRegistry()
    ntx_exec.COUNTER.reset()
    ref = train_graph(graph, 1, frequency_band_batches(np.random.RandomState(0), BATCH, IMG),
                      backend="reference", program=program, device=device, registry=reg)
    totals = reg.totals("step0/")
    assert {k: totals.get(k) for k in MODEL_TOTALS} == MODEL_TOTALS, totals
    assert (ntx_exec.COUNTER.launches, ntx_exec.COUNTER.plain_calls) == (program.n_commands, 0)
    assert obs.get_active() is None
    print(f"  reference step under a registry: {totals}; loss {ref['losses'][0]:.6f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels.ops import strict_fp32

    strict_fp32()
    device = torch.device("cuda", 0)
    smoke = Smoke()
    info = smoke.phase("device", device_info)
    smoke.phase("build", build_kernels)
    if not smoke.failures:
        smoke.phase("streaming_matmul vs plain", check_streaming, smoke, device)
        smoke.phase("fused region vs plain", check_region, smoke, device)
        smoke.phase("main path", main_path, smoke, device)
        smoke.phase("ntx program path", ntx_program_path, smoke, device)
        smoke.phase("obs and timing model", obs_and_timing, device)
        smoke.phase("ssd_scan vs plain", check_ssd, smoke, device)
        if "ssd_scan" in smoke.kernels:
            smoke.phase("prefill path", prefill_path, smoke, device)
        smoke.phase("flash_attention vs plain", check_attention, smoke, device)
        if "flash_attention" in smoke.kernels:
            smoke.phase("qwen prefill path", qwen_prefill_path, smoke, device)
        smoke.phase("ntx_matmul vs plain", check_ntx_matmul, smoke, device)
        smoke.phase("conv2d_ntx vs plain", check_conv2d, smoke, device)
        smoke.phase("C5: short fp32 sums on FFMA", check_c5, device)
    if len(smoke.kernels) != 7 and "kernels" not in smoke.failures:
        smoke.failures.append("kernels")
    if smoke.failures:
        print(f"chip_smoke FAILED: {smoke.failures}", flush=True)
        return 1
    name, smi = info
    print(smi)
    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
