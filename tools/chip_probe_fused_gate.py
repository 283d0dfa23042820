"""Where the fused-vs-unfused gate's margin goes, on one CUDA card.

tests/test_torch_kernels_cuda.py::test_step_fused_matches_unfused holds one
paper-CNN step run by the fused region kernel (B1, csrc/fused_region.cu)
against the unfused step (streaming_matmul on csrc/ntx_gemm_wgmma.cu) at
rtol 1e-5 / atol 1e-6. This probe builds two variants of each kernel from
the sources in the checkout and reads, for every pair, on ten input sets
(the test's, chip_smoke.py's main path's and eight more seeds at batch 16):
fused vs unfused in units of that tolerance, and each step against the same
step in fp64 (chip_smoke.library_step). Then it times the variants in one
run, in the order A, B, B, A.

  region "tiles": the source as it is (the fc forward in K tiles of
      _block(K), slices of 8 summed from zero, IEEE adds in order);
  region "chain": the fc forward as one FMA chain over all of K;
  gemm "slice": the source as it is (each fp32 slice's lo.hi, hi.lo, hi.hi
      summed from zero on the tensor cores, then one IEEE add);
  gemm "apart": hi.hi summed from zero apart from the two small terms and
      added to them by an IEEE add first.

    python3 tools/chip_probe_fused_gate.py

Variant sources and libraries go to build/probe_fused_gate/.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

REGION_CHAIN = """      case OP_MM_FWD: {  // probe variant: one FMA chain over all of K
        const int K = r[4], N = r[5];
        for (int n = threadIdx.x; n < N; n += blockDim.x) {
          float acc = 0.f;
          for (int k = 0; k < K; ++k) acc = fmaf(a[k], b[k * N + n], acc);
          out[n] = acc;
        }
        break;
      }
"""
GEMM_SLICE = """      issue<T>(sl, at, bt, kk);
      wg_wait<0>();
      add_to(prod, sl);
"""
GEMM_APART = """      if constexpr (F::PARTS == 2) {
        slice_apart(prod, sl, sb, at, bt, kk);
      } else {
        issue<T>(sl, at, bt, kk);
        wg_wait<0>();
        add_to(prod, sl);
      }
"""
SLICE_APART_FN = """
// probe variant: lo.hi + hi.lo on the tensor cores from zero, hi.hi apart
// from zero, the two added by an IEEE add, then added to the tile's sum
__device__ __forceinline__ void slice_apart(float (&prod)[32], float (&sl)[32], float (&sb)[32],
                                            const uint8_t* at, const uint8_t* bt, int kk) {
  at += 32 * kk;
  bt += 32 * kk;
  fence_regs(sl);
  fence_regs(sb);
  wg_fence();
  Mma<float>::run(sl, kdesc(at + A_BYTES), kdesc(bt), 0);
  Mma<float>::run(sl, kdesc(at), kdesc(bt + B_BYTES), 1);
  Mma<float>::run(sb, kdesc(at), kdesc(bt), 0);
  wg_commit();
  wg_wait<0>();
  fence_regs(sl);
  fence_regs(sb);
#pragma unroll
  for (int i = 0; i < 32; ++i) prod[i] = __fadd_rn(prod[i], __fadd_rn(sl[i], sb[i]));
}

// fragment register i"""


def replaced(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"probe: the source no longer holds the expected text:\n{old}")
    return text.replace(old, new)


def variants(csrc: Path) -> dict[tuple[str, str], str]:
    region = (csrc / "fused_region.cu").read_text()
    i, j = region.find("      case OP_MM_FWD: {"), region.find("      case OP_MM_DW: {")
    if not 0 <= i < j:
        raise SystemExit("probe: fused_region.cu no longer holds the OP_MM_FWD case")
    gemm = (csrc / "ntx_gemm_wgmma.cu").read_text()
    apart = replaced(gemm, GEMM_SLICE, GEMM_APART)
    apart = replaced(apart, "\n// fragment register i", SLICE_APART_FN)
    apart = replaced(apart, "  float sl[32], prod[32];\n", "  float sl[32], prod[32], sb[32];\n")
    apart = replaced(apart, "    sl[i] = prod[i] = 0.f;\n", "    sl[i] = prod[i] = sb[i] = 0.f;\n")
    return {("fused_region", "tiles"): region,
            ("fused_region", "chain"): region[:i] + REGION_CHAIN + region[j:],
            ("ntx_gemm_wgmma", "slice"): gemm,
            ("ntx_gemm_wgmma", "apart"): apart}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_fused_gate: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.convert import params_from_jax
    from repro_torch.kernels import build, fused, ops, streaming
    from repro_torch.kernels import gemm_wgmma as gemm
    from repro_torch.lower import frequency_band_batches, paper_cnn_graph, plan_fusion, run_torch

    ops.strict_fp32()
    dev = torch.device("cuda", 0)
    out = ROOT / "build" / "probe_fused_gate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (lib, var), text in variants(build.CSRC).items():
        src = out / f"{lib}_{var}.cu"
        src.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
               str(out / f"lib{lib}_{var}.so"), str(src)]
        procs[lib, var] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)
    libs = {}
    for (lib, var), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(log)
            return 1
        regs = max(int(x) for x in re.findall(r"Used (\d+) registers", log))
        spill = max(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
        print(f"{lib} {var}: at most {regs} registers, {spill} bytes spilled")
        libs[lib, var] = ctypes.CDLL(str(out / f"lib{lib}_{var}.so"))

    def use(region: str, gemm_var: str) -> None:
        build._LIBS["fused_region"] = libs["fused_region", region]
        build._LIBS["ntx_gemm_wgmma"] = libs["ntx_gemm_wgmma", gemm_var]

    def units(got, ref) -> float:
        d = (got.double() - ref.double()).abs()
        return float((d / (cs.TOL["atol"] + cs.TOL["rtol"] * ref.double().abs())).max())

    def inputs(batch: int, seed: int, data_seed: int):
        graph = paper_cnn_graph(batch=batch, img=cs.IMG)
        x, labels = frequency_band_batches(np.random.RandomState(data_seed), batch, cs.IMG)(0)
        ins = {"x": torch.as_tensor(x, device=dev),
               "onehot": torch.as_tensor(np.eye(10, dtype=np.float32)[labels], device=dev),
               **params_from_jax(graph.init_params(seed=seed), graph, dev)}
        return graph, ins

    cases = [("test, batch 16", 16, 1, 16), ("main path, batch 64", 64, 0, 0)] + [
        (f"batch 16, seed {s}", 16, s, 100 + s) for s in range(2, 10)]
    sets = []
    for label, batch, seed, data_seed in cases:
        graph, ins = inputs(batch, seed, data_seed)
        sets.append((label, graph, ins,
                     cs.library_step(graph, {k: v.double() for k, v in ins.items()})))
    print("fused vs unfused in units of rtol 1e-5 / atol 1e-6 (worst output); each step vs "
          "the fp64 step (worst output)")
    for region in ("chain", "tiles"):
        for gemm_var in ("slice", "apart"):
            use(region, gemm_var)
            rows = []
            for label, graph, ins, ref in sets:
                f = run_torch(graph, ins, fuse=True, device=dev)
                u = run_torch(graph, ins, fuse=False, device=dev)
                worst = max(f, key=lambda k: units(f[k], u[k]))
                rows.append((label, worst, units(f[worst], u[worst]),
                             max(units(f[k], ref[k]) for k in f),
                             max(units(u[k], ref[k]) for k in u)))
            print(f"region {region}, gemm {gemm_var}: worst of the {len(rows)} sets "
                  f"{max(r[2] for r in rows):.4f}")
            for label, worst, fu, fr, ur in rows:
                print(f"  {label:>20}: fused vs unfused {fu:.4f} ({worst}); vs fp64: fused "
                      f"{fr:.4f}, unfused {ur:.4f}")

    graph, ins0 = inputs(cs.BATCH, 0, 0)
    region = plan_fusion(graph).segments[0].region
    rins = {n: ins0[n] for n, _ in region.inputs}
    run = fused.build_region_callable(region, device=dev)
    for var in ("chain", "tiles", "tiles", "chain"):
        use(var, "slice")
        print(f"region kernel, {var}: {cs.time_ms(lambda: run(rins), iters=50):.4f} ms by "
              f"events, {cs.device_ms(lambda: run(rins), iters=20):.4f} ms device", flush=True)

    calls = []
    orig = streaming.streaming_matmul
    streaming.streaming_matmul = lambda a, b: calls.append((a, b)) or orig(a, b)
    try:
        run_torch(graph, ins0, fuse=False, device=dev)
    finally:
        streaming.streaming_matmul = orig
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(100_352, 576, generator=g, device=dev)
    b = torch.randn(576, 192, generator=g, device=dev)
    for var in ("slice", "apart", "apart", "slice"):
        use("tiles", var)
        l1 = cs.time_ms(lambda: gemm.launch(a, b, block_k=ops.matmul_block_k(576)))
        step = cs.device_ms(lambda: [streaming.streaming_matmul(x, y) for x, y in calls])
        print(f"gemm {var}: GoogLeNet L1 fp32 {l1:.4f} ms by events; the step's {len(calls)} "
              f"streaming calls {step:.4f} ms device", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
