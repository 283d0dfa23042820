#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version at the shapes of the
main path, drives the main path — ``repro_torch.launch.train.run_ntx_cnn``
on the paper CNN at batch 64, img 32, fused and then ``--no-fuse`` — and
checks that it went through the kernels. The last lines are the card's
name and power limit, one ``{"kernels": [...]}`` JSON line, and
``{"ok": true, "device": {...}}``. Any failed phase makes it exit 1 without
that last line; with no CUDA device it exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks: HBM3 bandwidth and fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TOL = {"rtol": 1e-5, "atol": 1e-6}
BATCH, IMG, STEPS = 64, 32, 5


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work on the card, and which side bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
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
    """streaming_matmul vs its plain version on the operands of one unfused step."""
    import torch

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
    worst_rel, worst_abs = 0.0, 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes": 0.0, "flops": 0.0}
    print(f"{'call':>28} {'M':>6} {'N':>5} {'K':>6} {'err/|A||B|':>10} "
          f"{'ms':>8} {'plain':>8} {'lib':>8} {'bound':>8}")
    for i, (a, b) in enumerate(calls):
        m, k = a.shape
        n = b.shape[1]
        got = streaming.streaming_matmul(a, b)
        want = streaming.streaming_matmul_torch(a, b)
        scale = torch.matmul(a.abs(), b.abs()) + 1e-30
        rel = float(((got - want).abs() / scale).max())
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, max_abs(got, want))
        ms = time_ms(lambda: streaming.streaming_matmul(a, b))
        plain = time_ms(lambda: streaming.streaming_matmul_torch(a, b))
        lib = time_ms(lambda: torch.matmul(a, b))
        nbytes, flops = 4.0 * (m * k + k * n + m * n), 2.0 * m * n * k
        bnd, _ = bound_ms(nbytes, flops)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bnd), ("bytes", nbytes), ("flops", flops)):
            tot[key] += v
        view = "a.T" if a.stride(0) == 1 and m > 1 else ("b.T" if b.stride(0) == 1 and k > 1 else "")
        print(f"{f'step call {i} {view}':>28} {m:>6} {n:>5} {k:>6} {rel:>10.2e} "
              f"{ms:>8.4f} {plain:>8.4f} {lib:>8.4f} {bnd:>8.5f}")
        if rel > 1e-5:
            raise AssertionError(f"call {i} ({m}x{k} @ {k}x{n}): error {rel:.2e} of |A||B|")
    for label, a, b in extra:
        a, b = a.to(device), b.to(device)
        got = streaming.streaming_matmul(a, b)
        want = streaming.streaming_matmul_torch(a, b)
        err = max_abs(got, want)
        print(f"{label:>28} {a.shape[0]:>6} {b.shape[1]:>5} {a.shape[1]:>6} max_abs {err:.2e}")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    _, by = bound_ms(tot["bytes"], tot["flops"])
    print(f"one unfused step: {len(calls)} streaming_matmul calls, kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, torch.matmul "
          f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms "
          f"({tot['bytes']/1e6:.2f} MB, {tot['flops']/1e6:.1f} MFLOP); worst "
          f"error {worst_rel:.2e} of |A||B|, {worst_abs:.2e} absolute")
    smoke.kernels["streaming_matmul"] = {
        "name": "streaming_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/streaming_mm.cu",
        "replaces": "src/repro/kernels/streaming.py:96",
        "launches": None,
        "max_abs_err": worst_abs,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": by,
        "library_ms": tot["library_ms"],
        "calls_per_step": len(calls),
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
    """The fused-region kernel vs region_torch on the full-width region."""
    import torch

    from repro_torch.kernels import fused
    from repro_torch.lower import MaxPool2dSpec, RegionSpec, Stage, plan_fusion

    graph, inputs = main_path_graph_inputs(device)
    plan = plan_fusion(graph)
    assert plan.n_regions == 1 and not plan.fallback_steps, plan.fallback_steps
    region = plan.segments[0].region
    ins = {n: inputs[n] for n, _ in region.inputs}
    run = fused.build_region_callable(region, device=device)
    got = run(ins)
    want = fused.region_torch(region, ins)
    torch.cuda.synchronize()
    worst = 0.0
    for k, v in want.items():
        err = max_abs(got[k], v)
        worst = max(worst, err)
        print(f"  {k:>12} {tuple(v.shape)!s:>16} max_abs {err:.3e}")
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, **TOL, msg=f"fused region output {k}")
    lib = library_step(graph, ins)
    for k, v in want.items():
        torch.testing.assert_close(lib[k], v, rtol=1e-3, atol=1e-5,
                                   msg=f"eager-torch step output {k}")
    print(f"  eager-torch (cuDNN + autograd) step agrees within rtol 1e-3 / atol 1e-5; "
          f"max_abs {max(max_abs(lib[k], v) for k, v in want.items()):.3e}")

    # max-pool ties, exact: the all-ties window case and plateaued
    # activations at the main path's pool width
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
        pk = fused.build_region_callable(pool, device=device)(pins)["d_x"]
        pp = fused.region_torch(pool, pins)["d_x"]
        torch.testing.assert_close(pk, pp, rtol=0, atol=0, msg=f"maxpool ties {spec}")
        print(f"  maxpool ties {spec.in_h}x{spec.in_w}x{spec.c} batch {b}: exact")

    ms = time_ms(lambda: run(ins))
    plain = time_ms(lambda: fused.region_torch(region, ins))
    lib_ms = time_ms(lambda: library_step(graph, ins))
    nbytes, flops = region_work(region, ins, want)
    bnd, by = bound_ms(nbytes, flops)
    print(f"fused region {region.label} at batch {BATCH}, img {IMG}: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, eager torch {lib_ms:.4f} ms, bound {bnd:.5f} ms "
          f"({nbytes/1e6:.3f} MB, {flops/1e6:.1f} MFLOP, {by})")
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
    }


def main_path(smoke: Smoke, device):
    """run_ntx_cnn fused, then --no-fuse; every kernel must be launched."""
    import torch

    from repro_torch.kernels import fused, streaming
    from repro_torch.launch.train import run_ntx_cnn

    counters = (fused.COUNTER, streaming.COUNTER)
    runs = {}
    for fuse in (True, False):
        for c in counters:
            c.reset()
        res = run_ntx_cnn(STEPS, BATCH, IMG, fuse=fuse, device=device)
        counts = {c.name: (c.launches, c.plain_calls) for c in counters}
        print(f"  fuse={fuse}: launches / plain calls {counts}")
        runs[fuse] = (res, counts)
    launches = {"fused_region": runs[True][1]["fused_region"][0],
                "streaming_matmul": runs[False][1]["streaming_matmul"][0]}
    for name, k in smoke.kernels.items():
        k["launches"] = launches[name]
    for fuse, (res, counts) in runs.items():
        losses = res["losses"]
        assert losses[-1] < losses[0], f"fuse={fuse}: loss did not decrease {losses}"
        assert all(plain == 0 for _, plain in counts.values()), counts
        for k, v in res["first_outputs"].items():
            assert torch.isfinite(v).all(), f"fuse={fuse}: {k} not finite"
    assert launches["fused_region"] > 0, "the fused run launched no region kernel"
    assert launches["streaming_matmul"] > 0, "the unfused run launched no streaming_matmul"
    f0, u0 = runs[True][0]["first_outputs"], runs[False][0]["first_outputs"]
    assert set(f0) == set(u0)
    for k in f0:
        torch.testing.assert_close(f0[k], u0[k], **TOL, msg=f"step 0 fused vs unfused {k}")
    print(f"  step-0 outputs fused == unfused within rtol {TOL['rtol']} / atol "
          f"{TOL['atol']}; max_abs {max(max_abs(f0[k], u0[k]) for k in f0):.3e}")
    for fuse, (res, _) in runs.items():
        walls = res["walls"][1:]
        print(f"  fuse={fuse}: losses {[round(x, 5) for x in res['losses']]}, warm step "
              f"wall {sum(walls) / len(walls) * 1e3:.3f} ms (host clock, synchronised)")


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
    if len(smoke.kernels) != 2 and "kernels" not in smoke.failures:
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
