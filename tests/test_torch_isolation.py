"""The port stands alone: no JAX and nothing of the JAX package.

Every ``repro_torch`` module and ``chip_smoke``'s helpers are imported in a
fresh interpreter, which must then hold no ``jax*`` and no ``repro`` /
``repro.*`` module. ``chip_smoke.py`` must fail, printing no result,
without a CUDA device.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its helpers; main() runs only as a script
leaked = sorted(k for k in sys.modules
                if k == "jax" or k.startswith(("jax.", "jaxlib")) or k == "repro"
                or k.startswith("repro."))
print(json.dumps({{"modules": names, "leaked": leaked}}))
"""


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(args, capture_output=True, text=True, env=env, timeout=300, **kw)


def test_port_imports_no_jax_and_no_repro():
    proc = _run([sys.executable, "-c", _PROBE.format(root=str(ROOT))], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    for mod in ("repro_torch.kernels.fused", "repro_torch.kernels.streaming",
                "repro_torch.lower.executors", "repro_torch.launch.train",
                "repro_torch.core.conv_decomp", "repro_torch.convert",
                "repro_torch.kernels.ssd_scan", "repro_torch.kernels.ref",
                "repro_torch.models.config", "repro_torch.models.blocks",
                "repro_torch.models.ssm", "repro_torch.models.transformer",
                "repro_torch.models.lm", "repro_torch.configs",
                "repro_torch.configs.mamba2_780m", "repro_torch.kernels.flash_attention",
                "repro_torch.models.attention", "repro_torch.configs.qwen1_5_0_5b",
                "repro_torch.core.precision", "repro_torch.core.tiling",
                "repro_torch.kernels.ntx_matmul", "repro_torch.kernels.conv2d",
                "repro_torch.kernels.flash_attention_wgmma",
                "repro_torch.kernels.conv2d_ntx_wgmma", "repro_torch.kernels.gemm_wgmma",
                "repro_torch.kernels.ssd_scan_wgmma", "repro_torch.kernels.flash_attention_tf32",
                "repro_torch.kernels.conv2d_ntx_tf32", "repro_torch.kernels.conv2d_ntx_stem",
                "repro_torch.kernels.ssd_scan_tf32", "repro_torch.core.ntx",
                "repro_torch.kernels.ntx_exec", "repro_torch.lower.ir",
                "repro_torch.lower.rules", "repro_torch.lower.graph",
                "repro_torch.lower.fuse", "repro_torch.runtime",
                "repro_torch.runtime.dma", "repro_torch.runtime.cmdqueue",
                "repro_torch.runtime.scheduler", "repro_torch.obs",
                "repro_torch.obs.counters", "repro_torch.obs.report",
                "repro_torch.obs.trace"):
        assert mod in res["modules"]


def test_port_sources_name_no_jax():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    files += list((ROOT / "tools").glob("chip_*.py"))  # chip probes run beside chip_smoke.py
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import repro.", "from repro.",
                                     "from repro import", "import repro ")), f"{f}: {s}"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script is the chip check there")
    proc = _run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
