"""The decoder stack (``repro/models/transformer.py``), Mamba-2 layers so far.

Layers are grouped into pattern units as in the JAX package; where JAX
stacks equal-kind layers along a leading axis and ``lax.scan``s over them,
the port keeps one module per layer — ``units[pos][u]`` is the layer of
pattern position ``pos`` in unit ``u`` — and loops over them. Only the
``("ssm", None)`` layer kind is ported; attention, RG-LRU, MLP and MoE
layers raise, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import ParamTree, apply_norm, init_norm
from repro_torch.models.config import ModelConfig, ParallelCtx


def _not_ported(kind) -> NotImplementedError:
    return NotImplementedError(
        f"layer kind {kind!r} is not ported yet (ROADMAP A5: attention with the "
        f"flash-attention kernel B3, MLP, MoE and RG-LRU layers); ported: ('ssm', None)"
    )


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------


def init_layer(cfg: ModelConfig, kind, gen: torch.Generator | None, device) -> ParamTree:
    mixer, ffn = kind
    if mixer != "ssm" or ffn is not None:
        raise _not_ported(kind)
    p: dict[str, Any] = {"norm1": init_norm(cfg.d_model, cfg.norm_type, device)}
    p["ssm"] = ssm_mod.init_ssm_block(cfg, gen, device, cfg.dtype)
    return ParamTree(p)


def apply_layer(x, p, cfg: ModelConfig, kind, ctx: ParallelCtx):
    mixer, ffn = kind
    if mixer != "ssm" or ffn is not None:
        raise _not_ported(kind)
    h = apply_norm(x, p["norm1"], cfg.norm_type, cfg.norm_eps)
    h = ssm_mod.ssm_block(h, p["ssm"], cfg, chunk=ctx.ssd_chunk)
    return x + h


# ---------------------------------------------------------------------------
# Full decoder stack (a loop over pattern units)
# ---------------------------------------------------------------------------


def _unit_counts(cfg: ModelConfig) -> tuple[int, int]:
    plen = len(cfg.pattern)
    return cfg.n_layers // plen, cfg.n_layers % plen


def init_decoder(cfg: ModelConfig, gen: torch.Generator | None, device) -> ParamTree:
    """``units[pos][u]`` and ``rem[i]``, each layer drawn in JAX's layer order."""
    n_units, rem = _unit_counts(cfg)
    units = nn.ModuleList(nn.ModuleList() for _ in cfg.pattern)
    for _ in range(n_units):
        for pos, kind in enumerate(cfg.pattern):
            units[pos].append(init_layer(cfg, kind, gen, device))
    rem_layers = nn.ModuleList(
        init_layer(cfg, cfg.pattern[i], gen, device) for i in range(rem)
    )
    return ParamTree({"units": units, "rem": rem_layers})


def decoder(x, params, cfg: ModelConfig, ctx: ParallelCtx):
    """x: (B, S, D) -> (B, S, D).

    No ported layer has an auxiliary loss (JAX's MoE router losses), so
    unlike the JAX decoder this returns the activations alone.
    """
    n_units, _ = _unit_counts(cfg)
    for u in range(n_units):
        for pos, kind in enumerate(cfg.pattern):
            x = apply_layer(x, params["units"][pos][u], cfg, kind, ctx)
    for i, p in enumerate(params["rem"]):
        x = apply_layer(x, p, cfg, cfg.pattern[i], ctx)
    return x
