"""How far the model-zoo training step's first gradients lie from fp64, by depth.

Gate A of ``chip_smoke.py``'s "train_lm" phase holds step 0's gradients
against the same step in fp64 (``launch.train.first_step_readings``). This
probe reads it, and the forward logits' relative RMS against fp64, for
Mamba-2 780M at full width (d_model 1,536) cut to 1, 3, 6, 12, 24 and 48
layers, for the bf16 model and for the same weights widened to fp32, and
for Qwen1.5-0.5B at its 24 layers beside them. Batch 8, seq 64, seed 0,
the step's first batch of the synthetic corpus, as in ``chip_smoke.py``:

    python3 tools/chip_probe_mamba_grads.py

Without CUDA it exits 2. It prints one line a case and the card's name and
power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = [("mamba2_780m", n, dt) for n in (1, 3, 6, 12, 24, 48) for dt in ("bf16", "fp32")] + \
    [("qwen1_5_0_5b", 24, "bf16"), ("qwen1_5_0_5b", 24, "fp32")]
BATCH, SEQ = 8, 64


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_mamba_grads: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataIterator, InMemoryDataset
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.models.config import ParallelCtx
    from repro_torch.optim import get_optimizer, tree_map

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    ctx = ParallelCtx(attn_backend="xla")
    for arch, n_layers, dt in CASES:
        cfg = get_config(arch).with_(n_layers=n_layers)
        state = train.init_train_state(0, cfg, get_optimizer("sgd", 0.1), device=dev)
        params = state["params"]
        if dt == "fp32":
            params = tree_map(lambda p: p.float(), params)
            cfg = cfg.with_(dtype=torch.float32)
        ds = InMemoryDataset.synthetic(2_000_000, cfg.vocab_size, SEQ, seed=0)
        batch = train.batch_to(next(DataIterator(ds, BATCH, seed=0)), dev)
        r = train.first_step_readings(cfg, params, batch, ctx)
        with torch.no_grad():
            got, _ = lm.forward(params, batch["inputs"], cfg, ctx)
            want, _ = lm.forward(tree_map(lambda p: p.double(), params), batch["inputs"],
                                 cfg.with_(dtype=torch.float64), ctx)
        fwd = float(torch.linalg.vector_norm(got.double() - want)
                    / torch.linalg.vector_norm(want))
        print(f"{arch} {n_layers:2d} layers {dt}: logits rel RMS vs fp64 {fwd:.3e}; grads: "
              f"p10 leaf {r['p10_leaf_rel_rms']:.4f}, worst leaf {r['leaf_rel_rms']:.4f} "
              f"({r['worst_leaf']}), grad norm rel {r['grad_norm_rel']:.3e}, ce rel "
              f"{r['ce_rel']:.3e} [{smi}]", flush=True)
        del state, params, got, want
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
