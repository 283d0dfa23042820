"""Warm step wall of the paper-CNN training driver with and without telemetry.

Runs ``repro_torch.launch.train.run_ntx_cnn`` fused at the main path's
width (batch 64, img 32) on one CUDA card, ``--steps`` steps a run, in the
order plain, instrumented (``metrics=`` and ``trace=`` into a temporary
directory), instrumented, plain, ``--rounds`` times, with ``gc.collect()``
before each run and the driver's printing discarded. For each run it
prints the mean and median of the warm steps' walls (steps 1 on; host
clock to a device synchronise, as ``train_graph`` reads them), then each
variant's median of the run medians and the run medians by position in
the round, which shows an order effect apart from the telemetry's own.

    python3 tools/chip_time_obs.py [--steps 20] [--rounds 4]

Without CUDA it exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_time_obs: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.launch.train import run_ntx_cnn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    with contextlib.redirect_stdout(io.StringIO()):  # build and warm the kernel
        run_ntx_cnn(2, 64, 32, device=device)
    order = (False, True, True, False)
    medians: dict[bool, list[float]] = {False: [], True: []}
    by_position: list[list[float]] = [[] for _ in order]
    losses = None
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(args.rounds):
            for pos, instrumented in enumerate(order):
                files = (dict(metrics=f"{tmp}/m.jsonl", trace=f"{tmp}/t.json")
                         if instrumented else {})
                gc.collect()
                with contextlib.redirect_stdout(io.StringIO()):
                    res = run_ntx_cnn(args.steps, 64, 32, device=device, **files)
                if losses is None:
                    losses = res["losses"]
                assert res["losses"] == losses, "telemetry changed the losses"
                walls = [w * 1e3 for w in res["walls"][1:]]
                med = statistics.median(walls)
                medians[instrumented].append(med)
                by_position[pos].append(med)
                print(f"round {r} {'instrumented' if instrumented else 'plain':>12}: warm step "
                      f"wall mean {statistics.mean(walls):.3f} ms, median {med:.3f} ms",
                      flush=True)
    plain, instr = statistics.median(medians[False]), statistics.median(medians[True])
    print(f"on {card}: {args.steps} steps a run, {args.rounds} rounds; median of the run "
          f"medians: plain {plain:.3f} ms, instrumented {instr:.3f} ms "
          f"({instr - plain:+.3f} ms); losses bit-identical in every run")
    print("run medians by position in the round (plain, instrumented, instrumented, "
          "plain): " + "; ".join(
              f"{pos + 1}: " + ", ".join(f"{m:.3f}" for m in ms)
              for pos, ms in enumerate(by_position)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
