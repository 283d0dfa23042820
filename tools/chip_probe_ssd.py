"""The bf16 tensor-core SSD scan at the shapes it takes, on one CUDA card.

Builds csrc/ssd_scan.cu and csrc/ssd_scan_wgmma.cu from the checkout, prints
ptxas's registers and spills and the SASS counts of HGMMA and UTMALDG, then
for five shapes (the Mamba-2 780M's P 64, N 128, chunk 128 at four heads and
at full width; chunk 64 with G 2; P 128, N 256; dt up to 1.0 with G 2) reads
the tensor-core entry against the plain version, the sequential ssd_ref,
its own emulation (ssd_scan_wgmma.emulate) and the fp64 SSD rounded once
(the share of y's elements off it, the plain version's beside it), and
checks run == run and strided == contiguous. At full width it times the
tensor-core entry and the FFMA bf16 entry by CUDA events in the order A, B,
B, A, and the tensor-core entry's passes by torch.profiler.

    python3 tools/chip_probe_ssd.py

Without CUDA it exits 2.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SHAPES = [  # (label, (B, H, G, S, P, N), chunk, dt_max)
    ("780M heads, 4 of them", (1, 4, 1, 256, 64, 128), 128, 0.1),
    ("chunk 64, G 2", (1, 4, 2, 256, 64, 64), 64, 0.1),
    ("P 128, N 256", (1, 4, 2, 256, 128, 256), 128, 0.1),
    ("780M full width", (2, 48, 1, 2048, 64, 128), 128, 0.1),
    ("dt to 1.0, G 2", (1, 48, 2, 256, 64, 128), 128, 1.0),
]


def rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_ssd: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import kernel_ms, ssd_inputs, time_ms
    from repro_torch.kernels import build, ssd_scan
    from repro_torch.kernels import ssd_scan_wgmma as wgmma
    from repro_torch.kernels.ops import strict_fp32
    from repro_torch.kernels.ref import ssd_ref, ssd_rounded_once_share

    strict_fp32()
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    paths = build.build_all(("ssd_scan", wgmma.LIB))
    for line in build.BUILD_LOGS.get(wgmma.LIB, "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    sass = subprocess.run([str(Path(build.nvcc_path()).parent / "cuobjdump"), "-sass",
                           str(paths[wgmma.LIB])], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    print(f"  SASS: HGMMA {sass.count('HGMMA')}, UTMALDG {sass.count('UTMALDG')}")

    bf16, ok = torch.bfloat16, True
    for label, shape, chunk, dt_max in SHAPES:
        x, la, b, c = ssd_inputs(shape, bf16, dev, 1, dt_max=dt_max)
        ssd_scan.COUNTER.reset()
        got = ssd_scan.ssd_scan(x, la, b, c, chunk=chunk)
        entries = dict(ssd_scan.COUNTER.entries)
        plain = ssd_scan.ssd_scan_torch(x, la, b, c, chunk=chunk)
        emu = wgmma.emulate(x, la, b, c, chunk=chunk)
        again = ssd_scan.ssd_scan(x, la, b, c, chunk=chunk)
        same = ssd_scan.ssd_scan(*ssd_inputs(shape, bf16, dev, 1, dt_max=dt_max,
                                             layout="contiguous"), chunk=chunk)
        torch.cuda.synchronize()
        share = ssd_rounded_once_share(got, x, la, b, c)
        print(f"{label}: {entries}; finite {bool(torch.isfinite(got).all())}; of max|y|: vs "
              f"plain {rel(got, plain):.3e}, vs ssd_ref {rel(got, ssd_ref(x, la, b, c)):.3e}; "
              f"elements off the emulation {float((got != emu).double().mean()):.4%}; "
              f"rounded-once share {share:.4%} (plain "
              f"{ssd_rounded_once_share(plain, x, la, b, c):.4%}); run == run "
              f"{torch.equal(again, got)}, strided == contiguous {torch.equal(same, got)}")
        ok &= entries == {wgmma.ENTRY: 1} and torch.equal(again, got) and torch.equal(same, got)

    x, la, b, c = ssd_inputs(SHAPES[3][1], bf16, dev, 1)

    def kernel():
        return ssd_scan.ssd_scan(x, la, b, c)

    def ffma():
        return ssd_scan.launch(ssd_scan.FFMA[bf16], x, la, b, c)

    times = [time_ms(fn) for fn in (kernel, ffma, ffma, kernel)]
    print(f"full width, ms by events in the order A B B A: {wgmma.ENTRY} {times[0]:.4f} / "
          f"{times[3]:.4f}, ssd_scan_bf16 (FFMA) {times[1]:.4f} / {times[2]:.4f}")
    for name, ms in sorted(kernel_ms(kernel).items(), key=lambda kv: -kv[1]):
        print(f"  {ms:.4f} ms  {name[:90]}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
