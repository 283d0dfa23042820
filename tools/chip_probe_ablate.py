"""Where the time of the two kernels goes: ablated builds, timed on one CUDA card.

Each ablation is a copy of a kernel source with one part taken out by a
text substitution (the result is then wrong; only its time is read),
built with the repo's ``nvcc`` flags into the gitignored ``build/ablate/``
and loaded in place of the real library. Time saved against the real build
is what that part costs on the critical path.

* ``csrc/conv2d_ntx_stem.cu`` at GoogLeNet L0 (batch 32, 224 x 224 x 3
  padded, 7 x 7, stride 2 -> 64; fp32 on NCHW data viewed as NHWC, bf16
  NHWC), CUDA events over 20 calls: without the y stores, without the
  ``wgmma`` products, without the slab's loads from x.
* ``csrc/ssd_scan_tf32.cu`` at the Mamba-2 780M prefill shape (B 2, H 48,
  G 1, S 2,048, P 64, N 128, chunk 128), each pass's device time by
  ``torch.profiler`` over 10 calls: the out pass without its decays, without
  the inter term's products, without its shared-memory stores (the split),
  without its next-stage loads, and every pass without the ``wgmma``
  products.

    python3 tools/chip_probe_ablate.py

Without CUDA it exits 2.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]
OUT = ROOT / "build" / "ablate"

# products that do nothing: every tf32 / bf16 wgmma of a source
NO_MMA = ('#include "sm90.cuh"\n', '#include "sm90.cuh"\n'
          "template <int N> struct NoMma {\n"
          "  static __device__ __forceinline__ void rs(float (&)[32], const uint32_t (&)[4],"
          " uint64_t, int) {}\n"
          "  static __device__ __forceinline__ void ss(float (&)[32], uint64_t, uint64_t, int) {}\n"
          "};\n#define Tf32Mma NoMma\n")
STEM = {
    "no y stores": [("store_y<U>(y, base + 8 * j, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);",
                     "if (acc[j] == 12345.f) store_y<U>(y, base, acc[0], acc[1]);")],
    "no products": [NO_MMA, ("        if (kk < d.kslices) bf16_rs(", "        if (kk < 0) bf16_rs(")],
    "no slab loads": [("? xb[r * d.sxh + c * d.sxw + ci * d.sxc] : U(0);", "? U(e & 1) : U(0);")],
}
SSD = {
    "out: no decays": [("expf(static_cast<float>(cum64[row] - cum64[col]))", "1.f")],
    "out: no inter products": [
        ("      stage_ss(acc, st + wg * TILE_BYTES, st + RT * TILE_BYTES);\n", "")],
    "out: no split stores": [
        ("      rc.store(st, tid);\n      rh.store(st + RT * TILE_BYTES, tid);", ""),
        ("      rx.store(st, nullptr, tid);", "")],
    "out: no next-stage loads": [
        ("#pragma unroll 1\n  for (int t = 0; t < NS; ++t) {\n#pragma unroll\n"
         "    for (int k = 0; k < 16; ++k) sv[k] = sn[k];\n    if (t + 1 < NS) load(t + 1);",
         "#pragma unroll 1\n  for (int t = 0; t < NS; ++t) {\n#pragma unroll\n"
         "    for (int k = 0; k < 16; ++k) sv[k] = sn[k];")],
    "no products": [(NO_MMA[0].replace("sm90", "ssd_scan_common"),
                     NO_MMA[1].replace("sm90", "ssd_scan_common"))],
}


def build_variants(lib: str, variants: dict) -> dict[str, Path]:
    """Every variant of csrc/<lib>.cu built at once; {name: library}."""
    from repro_torch.kernels import build

    src = (build.CSRC / f"{lib}.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in {"real": [], **variants}.items():
        text = src
        for a, b in subs:
            if a not in text:
                raise RuntimeError(f"{lib}: {name}: the source no longer holds {a[:60]!r}")
            text = text.replace(a, b)
        tag = re.sub(r"\W+", "_", name).strip("_")
        cu, so = OUT / f"{lib}_{tag}.cu", OUT / f"lib{lib}_{tag}.so"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{lib}: {name} did not build:\n{log}")
        libs[name] = so
    return libs


def use(lib: str, so: Path) -> None:
    from repro_torch.kernels import build

    build._LIBS[lib] = ctypes.CDLL(str(so))


def events_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def passes_ms(fn, iters: int = 10) -> dict[str, float]:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = (re.findall(r"ssd_(?:tf32|chunk)_(\w+)", e.key) or [e.key[:24]])[0]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / iters
    return out


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_probe_ablate: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import conv2d, ssd_scan
    from repro_torch.kernels import conv2d_ntx_stem as stem
    from repro_torch.kernels import ssd_scan_tf32 as tf32
    from repro_torch.kernels.ops import strict_fp32

    strict_fp32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(10)
    x32 = F.pad(torch.randn(32, 3, 224, 224, generator=g, device=dev), (3, 3, 3, 3))
    x32 = x32.permute(0, 2, 3, 1)
    w32 = torch.randn(7, 7, 3, 64, generator=g, device=dev) * 0.2
    x16 = F.pad(torch.randn(32, 224, 224, 3, generator=g, device=dev), (0, 0, 3, 3, 3, 3))
    x16, w16 = x16.bfloat16(), w32.bfloat16()
    print("conv2d_ntx_stem at GoogLeNet L0, batch 32, ms by events:")
    for name, so in build_variants(stem.LIB, STEM).items():
        use(stem.LIB, so)
        times = [events_ms(lambda: conv2d.launch(stem.ENTRY, x, w, stride=2))
                 for x, w in ((x32, w32), (x16, w16))]
        print(f"  {name:>16}: fp32 {times[0]:.4f}, bf16 {times[1]:.4f}", flush=True)

    rng = np.random.RandomState(0)
    bb, h, gg, s, p, n = 2, 48, 1, 2048, 64, 128
    x = torch.as_tensor(rng.randn(bb, s, h, p) * 0.5, dtype=torch.float32).to(dev).transpose(1, 2)
    la = -torch.as_tensor(rng.rand(bb, s, h) * 0.1, dtype=torch.float32) * torch.arange(1, h + 1)
    la = la.to(dev).transpose(1, 2)
    b = torch.as_tensor(rng.randn(bb, s, gg, n) * 0.3, dtype=torch.float32).to(dev).transpose(1, 2)
    c = torch.as_tensor(rng.randn(bb, s, gg, n) * 0.3, dtype=torch.float32).to(dev).transpose(1, 2)
    print("ssd_scan_f32_tf32 at the Mamba-2 780M prefill shape, device ms a pass:")
    for name, so in build_variants(tf32.LIB, SSD).items():
        use(tf32.LIB, so)
        ms = passes_ms(lambda: ssd_scan.launch(tf32.ENTRY, x, la, b, c, chunk=128))
        print(f"  {name:>24}: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ms.items()))
              + f"; total {sum(ms.values()):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
