"""Architecture configs of the port (counterpart of ``repro/configs``).

:data:`ARCHS` names every architecture of the JAX package; only those in
:data:`PORTED` have a module here so far. :func:`get_config` raises for the
others, naming the ROADMAP item that ports them. :func:`reduce_config` is
the JAX package's family-preserving smoke-scale shrink.
"""

from __future__ import annotations

import importlib

import torch

from repro_torch.models.config import ModelConfig

ARCHS = (
    "recurrentgemma_2b",
    "llava_next_mistral_7b",
    "llama3_2_3b",
    "qwen2_5_32b",
    "qwen1_5_0_5b",
    "qwen3_8b",
    "musicgen_medium",
    "llama4_maverick_400b_a17b",
    "qwen3_moe_235b_a22b",
    "mamba2_780m",
)
PORTED = ("mamba2_780m", "qwen1_5_0_5b")


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP A7, the other archs: its config "
            f"module, and models/moe.py or models/rglru.py where it has those "
            f"layers); ported: {PORTED}"
        )
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving smoke-scale shrink (same pattern, tiny dims).

    The JAX package's shrink for the ported families (attention, sliding
    window, SSM); the MoE and RG-LRU branches come with the slices that port
    those layers.
    """
    if cfg.n_experts or cfg.lru_width:
        raise NotImplementedError(f"reduce_config: {cfg.name} has MoE or RG-LRU layers, "
                                  f"not ported yet (ROADMAP A7: models/moe.py, models/rglru.py)")
    plen = len(cfg.pattern)
    n_layers = plen * 2 + (1 if cfg.n_layers % plen else 0)
    kv_ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_heads = 4
    n_kv = max(1, n_heads // kv_ratio)
    kw = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        window=min(cfg.window, 8) if cfg.window else None,
        dtype=torch.float32,
    )
    if cfg.ssm_state:
        kw.update(n_heads=8, ssm_headdim=16, ssm_state=16, ssm_groups=min(2, cfg.ssm_groups))
    return cfg.with_(**kw)
