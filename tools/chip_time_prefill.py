"""Warm wall of an fp32 prefill in one or more checkouts, on one CUDA card.

For each ROOT in the order given (a checkout of this repo; the default is
this one), a process of its own imports that checkout's ``repro_torch``,
builds its kernels from its sources on first use, makes the model at full
width and depth from seed 0 in bf16, widened in place to fp32 as
``chip_smoke.py`` does, and prefills 2 x 2,048 tokens: once to build and
warm, then :data:`WARM` times on the host's clock, synchronised, as
``chip_smoke.py`` times its prefill. ``--model`` picks Qwen1.5-0.5B (24
layers, d_model 1024, vocab 151,936; the attention kernel, the default) or
Mamba-2 780M (48 layers, d_model 1536, vocab 50,288; the SSD kernel). It
prints each run's walls, their mean and the path kernel's launches per C
entry. To compare two trees in one call, unpack one under the gitignored
``build/`` and name them A B B A:

    python3 tools/chip_time_prefill.py [--model mamba2_780m] [ROOT ...]

Without CUDA it exits 2.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARM = 3  # timed prefills a checkout, as chip_smoke.py's
# model -> (the kernel module of its path, token ids below this)
MODELS = {"qwen1_5_0_5b": ("flash_attention", 151_936), "mamba2_780m": ("ssd_scan", 50_280)}


def one(root: Path, model: str) -> dict:
    """The prefill's walls in ``root``'s port (run in a process of its own)."""
    sys.path[:0] = [str(root / "src")]
    import importlib

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import strict_fp32
    from repro_torch.models.config import ParallelCtx
    from repro_torch.models.lm import init_lm, prefill

    strict_fp32()
    device = torch.device("cuda", 0)
    name, high = MODELS[model]
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    cfg, ctx = get_config(model), ParallelCtx()
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, high, (2, 2048)),
                             device=device)
    params = init_lm(cfg, seed=0, device=device)
    params.to(torch.float32)  # in place: the same weights, widened
    cfg = cfg.with_(dtype=torch.float32)
    mod.COUNTER.reset()
    prefill(params, tokens, cfg, ctx)
    torch.cuda.synchronize()
    entries = dict(mod.COUNTER.entries)
    walls = []
    for _ in range(WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, tokens, cfg, ctx)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"root": str(root), "model": model, "walls_ms": walls,
            "mean_ms": sum(walls) / len(walls), "entries": entries}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path, default=[ROOT])
    ap.add_argument("--model", choices=sorted(MODELS), default="qwen1_5_0_5b")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_time_prefill: no CUDA device is available", file=sys.stderr)
        return 2
    if args.one is not None:
        print(json.dumps(one(args.one.resolve(), args.model)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    results = []
    for root in args.roots:
        out = subprocess.run([sys.executable, __file__, "--model", args.model, "--one",
                              str(root.resolve())],
                             capture_output=True, text=True, timeout=1200)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        r = json.loads(out.stdout.strip().splitlines()[-1])
        results.append(r)
        print(f"{root}: {args.model} fp32 warm prefill wall {r['mean_ms']:.3f} ms (mean of "
              f"{WARM}: {[round(w, 3) for w in r['walls_ms']]}); {MODELS[args.model][0]} "
              f"launches {r['entries']}", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
