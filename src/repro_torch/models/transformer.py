"""The decoder stack (``repro/models/transformer.py``).

Layers are grouped into pattern units as in the JAX package; where JAX
stacks equal-kind layers along a leading axis and ``lax.scan``s over them,
the port keeps one module per layer — ``units[pos][u]`` is the layer of
pattern position ``pos`` in unit ``u`` — and loops over them. Ported mixers:
``"attn"`` (full causal attention), ``"swa"`` (the same block with
``window=cfg.window``) and ``"ssm"`` (Mamba-2); ported FFNs: ``"mlp"`` and
none. RG-LRU mixers and MoE FFNs raise, naming the ROADMAP item that ports
them.

Decode keeps one cache per layer in the same layout, ``units[pos][u]`` and
``rem[i]`` (:func:`init_decoder_cache`), where JAX stacks each pattern
position's caches along a leading axis; :func:`decoder_step` runs one token
through the stack.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import ParamTree, apply_norm, init_mlp, init_norm, mlp
from repro_torch.models.config import ModelConfig, ParallelCtx

MIXERS = ("attn", "swa", "ssm")
FFNS = ("mlp", None)


def _check_kind(kind) -> None:
    mixer, ffn = kind
    if mixer not in MIXERS or ffn not in FFNS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP A7: models/moe.py and "
            f"models/rglru.py); "
            f"ported mixers {MIXERS}, FFNs {FFNS}"
        )


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------


def init_layer(cfg: ModelConfig, kind, gen: torch.Generator | None, device) -> ParamTree:
    _check_kind(kind)
    mixer, ffn = kind
    p: dict[str, Any] = {"norm1": init_norm(cfg.d_model, cfg.norm_type, device)}
    if mixer == "ssm":
        p["ssm"] = ssm_mod.init_ssm_block(cfg, gen, device, cfg.dtype)
    else:
        p["attn"] = attn_mod.init_attention(cfg, gen, device, cfg.dtype)
    if ffn is not None:
        p["norm2"] = init_norm(cfg.d_model, cfg.norm_type, device)
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_act, gen, device, cfg.dtype)
    return ParamTree(p)


def apply_layer(x, p, cfg: ModelConfig, kind, ctx: ParallelCtx):
    _check_kind(kind)
    mixer, ffn = kind
    h = apply_norm(x, p["norm1"], cfg.norm_type, cfg.norm_eps)
    if mixer == "ssm":
        h = ssm_mod.ssm_block(h, p["ssm"], cfg, backend=ctx.attn_backend,
                              chunk=ctx.ssd_chunk)
    else:
        window = cfg.window if mixer == "swa" else None
        h = attn_mod.attention_block(h, p["attn"], cfg, window=window,
                                     backend=ctx.attn_backend, block_kv=ctx.block_kv)
    x = x + h
    if ffn is not None:
        h = apply_norm(x, p["norm2"], cfg.norm_type, cfg.norm_eps)
        x = x + mlp(h, p["mlp"], cfg.mlp_act)
    return x


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


# ---------------------------------------------------------------------------
# Decode (single token)
# ---------------------------------------------------------------------------


def init_layer_cache(cfg: ModelConfig, kind, batch: int, max_len: int, dtype=None,
                     device=None) -> dict:
    _check_kind(kind)
    mixer, _ = kind
    dtype = dtype or cfg.dtype
    if mixer == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    window = cfg.window if mixer == "swa" else None
    return attn_mod.init_kv_cache(cfg, batch, max_len, window, dtype, device)


def apply_layer_step(x, p, cfg: ModelConfig, kind, cache: dict, pos: int, ctx: ParallelCtx):
    """One token through one layer. x: (B, 1, D). Returns (x, the layer's cache)."""
    _check_kind(kind)
    mixer, ffn = kind
    h = apply_norm(x, p["norm1"], cfg.norm_type, cfg.norm_eps)
    if mixer == "ssm":
        h, cache = ssm_mod.ssm_block_step(h, p["ssm"], cfg, cache)
    else:
        window = cfg.window if mixer == "swa" else None
        h, cache = attn_mod.decode_attention_block(h, p["attn"], cfg, cache, pos,
                                                   window=window)
    x = x + h
    if ffn is not None:
        h = apply_norm(x, p["norm2"], cfg.norm_type, cfg.norm_eps)
        x = x + mlp(h, p["mlp"], cfg.mlp_act)
    return x, cache


def init_decoder_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                       device=None) -> dict:
    """``{"units": [[cache of layer (pos, u)] for pos], "rem": [cache]}``."""
    n_units, rem = _unit_counts(cfg)
    units = [[init_layer_cache(cfg, kind, batch, max_len, dtype, device) for _ in range(n_units)]
             for kind in cfg.pattern]
    rem_caches = [init_layer_cache(cfg, cfg.pattern[i], batch, max_len, dtype, device)
                  for i in range(rem)]
    return {"units": units, "rem": rem_caches}


def decoder_step(x, params, cfg: ModelConfig, cache: dict, pos: int, ctx: ParallelCtx):
    """One decode step through the whole stack. x: (B, 1, D). Returns (x, cache)."""
    n_units, _ = _unit_counts(cfg)
    units = [list(c) for c in cache["units"]]
    for u in range(n_units):
        for p_idx, kind in enumerate(cfg.pattern):
            x, units[p_idx][u] = apply_layer_step(x, params["units"][p_idx][u], cfg, kind,
                                                  units[p_idx][u], pos, ctx)
    rem = list(cache["rem"])
    for i, p in enumerate(params["rem"]):
        x, rem[i] = apply_layer_step(x, p, cfg, cfg.pattern[i], rem[i], pos, ctx)
    return x, {"units": units, "rem": rem}
