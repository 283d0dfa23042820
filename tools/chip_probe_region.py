"""Where the shared-memory fused-region kernel's time goes, on one CUDA card.

Each variant is a copy of ``csrc/fused_region.cu`` changed by text
substitutions, built with the repo's ``nvcc`` flags into the gitignored
``build/probe_region/`` and launched through ``fused_region_smem_launch`` on
the paper-CNN region (batch 64, img 32, a cluster of 2 CTAs an image). An
ablated build's results are wrong; only its time is read. Every build
stamps ``clock64()`` in thread 0 of each CTA at its start, after the staging
and after each stage's barrier; the probe prints the mean over the CTAs of
each stage's cycles and the call's time by CUDA events (body and epilogue).

* "as is"; the conv dW pixel loops taken out; the conv forward and dX tap
  loops taken out; tile width 1 everywhere; the cluster barrier replaced by
  ``__syncthreads()``; the staged inputs in two ``cp.async`` groups (the
  first stage's inputs, then the rest, waited for before the second stage);
  768 and 1,024 threads a CTA;
* the epilogue merged behind an arrival counter (the last CTA to arrive sums
  the partials and updates) against the second launch, timed A B B A and
  held to the same bits;
* cluster sizes 8, 4 and 2 at batch 16 on the build as is, with the
  number of clusters of each size the card runs at once.

    python3 tools/chip_probe_region.py

Without CUDA it exits 2.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
OUT = ROOT / "build" / "probe_region"
BODY = "__global__ void __launch_bounds__(SMEM_THREADS, 1)\nregion_body_smem("
STAGED = ("  cluster_sync();  // every CTA of the cluster runs, its inputs staged, before any "
          "DSMEM store\n")
STAGE_END = ("    if (broadcast)\n      cluster_sync();\n    else\n      __syncthreads();\n"
             "  }\n}\n")
STAMPS = [
    (BODY, "__device__ long long g_stamp[1024][64];\n" + BODY),
    ("  const long long img = blockIdx.x / C;\n",
     "  const long long img = blockIdx.x / C;\n"
     "  if (threadIdx.x == 0) g_stamp[blockIdx.x][0] = clock64();\n"),
    (STAGED, STAGED + "  if (threadIdx.x == 0) g_stamp[blockIdx.x][1] = clock64();\n"),
    (STAGE_END, STAGE_END.replace(
        "  }\n}\n", "    if (threadIdx.x == 0) g_stamp[blockIdx.x][s + 2] = clock64();\n  }\n}\n")),
]
READ_STAMPS = ('\nextern "C" int read_stamps(long long* h) '
               '{ return cudaMemcpyFromSymbol(h, g_stamp, sizeof(g_stamp)); }\n')
THREADS = "constexpr int SMEM_THREADS = 512;"
VARIANTS = {
    "as is": [],
    "no dW pixel loops": [
        ("for (int ox = ox0; ox <= ox1; ++ox,", "for (int ox = ox0; ox <= ox1 && ox < 0; ++ox,")],
    "no fwd / dX tap loops": [
        (f"acc[{v}] = 0.f;\n    for (int dh = 0; dh < c.KH; ++dh) {{",
         f"acc[{v}] = 0.f;\n    for (int dh = 0; dh < c.KH && dh < 0; ++dh) {{")
        for v in "ji"],
    "tile width 1": [("  for (int t = 4; t > 1; t /= 2)\n", "  for (int t = 4; t > 4; t /= 2)\n")],
    "no cluster barrier": [("    if (broadcast)\n      cluster_sync();\n    else\n      "
                            "__syncthreads();", "    __syncthreads();")],
    "two cp.async groups": [
        ("  for (int i = 0; i < nbuf; ++i)\n    if (bufs.mode[i] & STAGED)\n"
         "      stage_in(sm + bufs.slot[i], bufs.g.ptr[i] + img * bufs.g.stride[i], "
         "bufs.numel[i]);\n"
         '  asm volatile("cp.async.wait_all;" ::: "memory");\n',
         "  for (int late = 0; late < 2; ++late) {\n    for (int i = 0; i < nbuf; ++i)\n"
         "      if ((bufs.mode[i] & STAGED) && (i == table[1] || i == table[2]) == !late)\n"
         "        stage_in(sm + bufs.slot[i], bufs.g.ptr[i] + img * bufs.g.stride[i], "
         "bufs.numel[i]);\n"
         '    asm volatile("cp.async.commit_group;" ::: "memory");\n  }\n'
         '  asm volatile("cp.async.wait_group 1;" ::: "memory");\n'),
        ("    const int* r = tab + s * REC;\n    const int op = r[0];\n",
         "    const int* r = tab + s * REC;\n    const int op = r[0];\n    if (s == 1) {\n"
         '      asm volatile("cp.async.wait_group 0;" ::: "memory");\n'
         "      __syncthreads();\n    }\n")],
    "768 threads": [(THREADS, "constexpr int SMEM_THREADS = 768;")],
    "1,024 threads": [(THREADS, "constexpr int SMEM_THREADS = 1024;")],
}
# the epilogue in the body: the last CTA to arrive sums the partials in image
# order and updates, as region_epilogue does; the second launch is dropped
MERGED = [
    (BODY, "__device__ unsigned int g_arrived = 0;\n__device__ const int* g_epi;\n"
           "__device__ int g_np, g_batch;\n__device__ float g_lr, g_mu;\n" + BODY),
    (STAGE_END, STAGE_END.replace("  }\n}\n", """  }
  __shared__ bool last_cta;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last_cta = atomicAdd(&g_arrived, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_cta) return;
  __threadfence();
  const RegionBufs& eb = bufs.g;
  for (int p = 0; p < g_np; ++p) {
    const int* r = g_epi + p * EPI_REC;
    for (int i = threadIdx.x; i < r[0]; i += blockDim.x) {
      float dw;
      if (r[1] >= 0) {
        dw = 0.f;
        for (int b = 0; b < g_batch; ++b) dw += __ldcg(eb.ptr[r[1]] + b * eb.stride[r[1]] + i);
      } else {
        dw = eb.ptr[r[2]][i];
      }
      if (r[3] >= 0) eb.ptr[r[3]][i] = dw;
      if (r[6] >= 0) {
        float v_new = dw;
        if (r[5] >= 0) {
          v_new = __fadd_rn(__fmul_rn(g_mu, eb.ptr[r[5]][i]), dw);
          eb.ptr[r[7]][i] = v_new;
        }
        eb.ptr[r[6]][i] = __fsub_rn(eb.ptr[r[4]][i], __fmul_rn(g_lr, v_new));
      }
    }
  }
  if (threadIdx.x == 0) g_arrived = 0;
}
""")),
    ("  return static_cast<int>(launch_epilogue(epi, n_params, max_numel, batch, lr, mu, bufs.g, "
     "s));\n}\n\n// How many",
     "  return static_cast<int>(cudaGetLastError());\n}\n\n"
     'extern "C" int set_epilogue(const void* epi, int np, int batch, float lr, float mu) {\n'
     "  const int* e = static_cast<const int*>(epi);\n"
     "  cudaMemcpyToSymbol(g_epi, &e, sizeof(e));\n"
     "  cudaMemcpyToSymbol(g_np, &np, sizeof(int));\n"
     "  cudaMemcpyToSymbol(g_batch, &batch, sizeof(int));\n"
     "  cudaMemcpyToSymbol(g_lr, &lr, sizeof(float));\n"
     "  return cudaMemcpyToSymbol(g_mu, &mu, sizeof(float));\n}\n\n// How many"),
]


def substituted(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"probe: the source no longer holds exactly one {old[:60]!r}")
        text = text.replace(old, new)
    return text


def sources(text: str) -> dict[str, str]:
    """Variant name -> source: each ablation stamped, and the merged epilogue."""
    out = {name: substituted(substituted(text, STAMPS), subs) + READ_STAMPS
           for name, subs in VARIANTS.items()}
    out["merged epilogue"] = substituted(text, MERGED)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_region: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.convert import params_from_jax
    from repro_torch.kernels import build, fused, ops
    from repro_torch.lower import frequency_band_batches, paper_cnn_graph, plan_fusion

    ops.strict_fp32()
    dev = torch.device("cuda", 0)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources((build.CSRC / "fused_region.cu").read_text()).items():
        stem = "v_" + "".join(ch if ch.isalnum() else "_" for ch in name)
        (OUT / f"{stem}.cu").write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(OUT / f"lib{stem}.so"),
               str(OUT / f"{stem}.cu")]
        procs[name] = (stem, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(log)
            return 1
        libs[name] = ctypes.CDLL(str(OUT / f"lib{stem}.so"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)

    def region_inputs(batch):
        graph = paper_cnn_graph(batch=batch, img=cs.IMG)
        x, labels = frequency_band_batches(np.random.RandomState(batch), batch, cs.IMG)(0)
        ins = {"x": torch.as_tensor(x, device=dev),
               "onehot": torch.as_tensor(np.eye(10, dtype=np.float32)[labels], device=dev),
               **params_from_jax(graph.init_params(seed=1), graph, dev)}
        region = plan_fusion(graph).segments[0].region
        return region, {n: ins[n] for n, _ in region.inputs}

    def launcher(lib, region, ins, cluster, threads=fused.SMEM_THREADS):
        """A call of ``lib``'s SMEM entry on fixed buffers, and its outputs."""
        k = fused.region_kernel(region, ins, dev)
        c, B = k.compiled, region.batch
        keep, ptrs, outs = [], [], {}
        for buf in c.buffers:
            t = None
            if buf.kind == "in":
                t = ins[buf.name].contiguous()
            elif buf.kind != "scratch":
                t = torch.empty(((B,) + buf.shape) if buf.batched else buf.shape, device=dev)
                if buf.kind == "out":
                    outs[buf.name] = t
            keep.append(t)
            ptrs.append(0 if t is None else t.data_ptr())
        fn = lib.fused_region_smem_launch
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                       + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        n = len(ptrs)
        args = (k.body.data_ptr(), c.n_stages, threads, k.epilogue.data_ptr(), c.n_params,
                c.max_param_numel, B, float(region.lr), float(region.momentum), n,
                (ctypes.c_longlong * n)(*ptrs), k.strides, cluster, 4 * c.smem, *k.smem_args,
                torch.cuda.current_stream(dev).cuda_stream)

        def call():
            build.check(fused._LIB, fn(*args), region.label)
        return call, outs, keep

    def us(call) -> float:
        return 1e3 * cs.time_ms(call, iters=200, warmup=10)

    region, ins = region_inputs(cs.BATCH)
    names = ["staging"] + [f"{st.node}.{st.pass_}" for st in region.stages if st.pass_ != "upd"]
    ctas = cs.BATCH * 2
    print(f"fused_region_smem_launch at batch {cs.BATCH}, img {cs.IMG}, cluster 2: cycles a "
          f"stage (mean over {ctas} CTAs), and us a call by events (body and epilogue)")
    for name in VARIANTS:
        threads = {"768 threads": 768, "1,024 threads": 1024}.get(name, fused.SMEM_THREADS)
        call, _, keep = launcher(libs[name], region, ins, 2, threads)
        t = us(call)
        call()
        torch.cuda.synchronize()
        stamps = np.zeros((1024, 64), np.int64)
        libs[name].read_stamps(stamps.ctypes.data_as(ctypes.c_void_p))
        cycles = np.diff(stamps[:ctas, :len(names) + 1].astype(np.float64), axis=1).mean(0)
        print(f"  {name}: {t:.2f} us, {cycles.sum():.0f} cycles: "
              + " ".join(f"{nm} {cy:.0f}" for nm, cy in zip(names, cycles)), flush=True)

    k = fused.region_kernel(region, ins, dev)
    libs["merged epilogue"].set_epilogue.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_float, ctypes.c_float]
    libs["merged epilogue"].set_epilogue(k.epilogue.data_ptr(), k.compiled.n_params, cs.BATCH,
                                         float(region.lr), float(region.momentum))
    two, two_outs, keep2 = launcher(build.library(fused._LIB), region, ins, 2)
    merged, merged_outs, keepm = launcher(libs["merged epilogue"], region, ins, 2)
    two()
    merged()
    torch.cuda.synchronize()
    same = all(torch.equal(two_outs[o], merged_outs[o]) for o in two_outs)
    times = [us(f) for f in (two, merged, merged, two)]
    print("epilogue: second launch / merged / merged / second launch "
          f"{', '.join(f'{t:.2f}' for t in times)} us; the same bits: {same}")

    region16, ins16 = region_inputs(16)
    k16 = fused.region_kernel(region16, ins16, dev)
    active = fused.active_clusters(4 * k16.compiled.smem, dev)
    row = []
    for cl in (8, 4, 2):
        call, _, keep = launcher(build.library(fused._LIB), region16, ins16, cl)
        row.append(f"C {cl} {us(call):.2f} us")
    print(f"batch 16: {', '.join(row)}; clusters the card runs at once by size {active}; the "
          f"route picks C {k16.cluster}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
