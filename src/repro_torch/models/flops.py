"""Analytic FLOP / byte / parameter counts per architecture and shape
(``repro/models/flops.py``, host arithmetic only).

Used by (a) the roofline tables (MODEL_FLOPS = 6·N·D for training, 2·N·D for
inference, + attention terms) and (b) the offload step report of
:func:`repro_torch.launch.train.offload_step_report`.
Counts follow the standard convention: a MAC = 2 flops; backward = 2x forward
matmul flops (dL/dx and dL/dw).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class Counts:
    params_total: int
    params_active: int  # per-token active (MoE: top_k experts only)
    flops_fwd_per_token: int  # matmul flops, excl. attention quadratic term
    attn_flops_fwd_per_token_per_ctx: float  # multiply by context length
    params_expert: int = 0  # routed-expert params (FSDP-sharded over DP)


def _layer_counts(cfg: ModelConfig, kind) -> tuple[int, int, float]:
    """(params, active_params, attn_per_ctx) for one layer of ``kind``."""
    mixer, ffn = kind
    d = cfg.d_model
    p_mix = 0
    attn_ctx = 0.0
    if mixer in ("attn", "swa"):
        qdim = cfg.n_heads * cfg.head_dim
        kvdim = cfg.n_kv_heads * cfg.head_dim
        p_mix = d * (qdim + 2 * kvdim) + qdim * d
        if cfg.qkv_bias:
            p_mix += qdim + 2 * kvdim
        # score+value flops per token per context position: 2*2*qdim
        attn_ctx = 4.0 * qdim
        if mixer == "swa" and cfg.window:
            attn_ctx = 0.0  # accounted as fixed window cost in flops_fwd
    elif mixer == "rec":
        dr = cfg.lru_width
        nb = 16
        p_mix = 2 * d * dr + dr * d + 4 * dr + 2 * nb * (dr // nb) ** 2 + dr
    elif mixer == "ssm":
        di = cfg.n_heads * cfg.ssm_headdim
        gn = cfg.ssm_groups * cfg.ssm_state
        p_mix = d * (2 * di + 2 * gn + cfg.n_heads) + di * d + 4 * (di + 2 * gn)
    p_ffn = a_ffn = 0
    if ffn == "mlp":
        mats = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
        p_ffn = a_ffn = mats * d * cfg.d_ff
    elif ffn == "moe":
        mats = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
        per_expert = mats * d * cfg.moe_d_ff
        p_ffn = cfg.n_experts * per_expert + d * cfg.n_experts
        a_ffn = cfg.top_k * per_expert + d * cfg.n_experts
        if cfg.shared_expert_d_ff:
            shared = mats * d * cfg.shared_expert_d_ff
            p_ffn += shared
            a_ffn += shared
    return p_mix + p_ffn, p_mix + a_ffn, attn_ctx


def fixed_mixer_flops_per_token(cfg: ModelConfig, kind) -> int:
    """Non-projection per-token flops (SWA window, SSM scan, RG-LRU scan)."""
    mixer, _ = kind
    if mixer == "swa" and cfg.window:
        return 4 * cfg.n_heads * cfg.head_dim * cfg.window
    if mixer == "ssm":
        # SSD: per token, per head: chunk-quadratic ~ 2*Q*(P+N) + state 4*P*N
        q = 128
        return cfg.n_heads * (2 * q * (cfg.ssm_headdim + cfg.ssm_state)
                              + 4 * cfg.ssm_headdim * cfg.ssm_state)
    if mixer == "rec":
        return 12 * cfg.lru_width
    return 0


def count(cfg: ModelConfig) -> Counts:
    plen = len(cfg.pattern)
    n_units, rem = divmod(cfg.n_layers, plen)
    layer_list = list(cfg.pattern) * n_units + list(cfg.pattern[:rem])

    p_total = p_active = p_expert = 0
    attn_ctx = 0.0
    fwd_fixed = 0
    mats = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    for kind in layer_list:
        p, a, c = _layer_counts(cfg, kind)
        p_total += p
        p_active += a
        attn_ctx += c
        fwd_fixed += fixed_mixer_flops_per_token(cfg, kind)
        if kind[1] == "moe":
            p_expert += cfg.n_experts * mats * cfg.d_model * cfg.moe_d_ff

    embed = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else cfg.d_model * cfg.n_codebooks * cfg.vocab_size
    p_total += embed + head
    p_active += embed + head

    # 2 flops per active param per token (embedding lookup ~free, head matmul
    # counted via its params).
    head_active = cfg.d_model * cfg.n_codebooks * cfg.vocab_size  # tied or not, the matmul runs
    fwd = 2 * (p_active - embed - head) + 2 * head_active + fwd_fixed
    return Counts(
        params_total=p_total,
        params_active=p_active,
        flops_fwd_per_token=fwd,
        attn_flops_fwd_per_token_per_ctx=attn_ctx,
        params_expert=p_expert,
    )


def train_step_flops(cfg: ModelConfig, seq: int, batch: int) -> float:
    """Total model flops for one training step (fwd + bwd = 3x fwd)."""
    c = count(cfg)
    tokens = seq * batch
    # mean attention context for causal = seq/2
    attn = c.attn_flops_fwd_per_token_per_ctx * (seq / 2.0)
    return 3.0 * tokens * (c.flops_fwd_per_token + attn)


def prefill_flops(cfg: ModelConfig, seq: int, batch: int) -> float:
    c = count(cfg)
    attn = c.attn_flops_fwd_per_token_per_ctx * (seq / 2.0)
    return float(seq * batch) * (c.flops_fwd_per_token + attn)


def decode_step_flops(cfg: ModelConfig, ctx_len: int, batch: int) -> float:
    """One token for every sequence in the batch, against a ctx_len cache."""
    c = count(cfg)
    attn = c.attn_flops_fwd_per_token_per_ctx * float(ctx_len)
    return float(batch) * (c.flops_fwd_per_token + attn)


def decode_hbm_bytes(cfg: ModelConfig, ctx_len: int, batch: int, dtype_bytes: int = 2) -> float:
    """Decode is memory-bound: params + KV/state reads dominate."""
    c = count(cfg)
    kv = 0.0
    plen = len(cfg.pattern)
    n_units, rem = divmod(cfg.n_layers, plen)
    layer_list = list(cfg.pattern) * n_units + list(cfg.pattern[:rem])
    for mixer, _ in layer_list:
        if mixer == "attn":
            kv += 2 * cfg.n_kv_heads * cfg.head_dim * ctx_len
        elif mixer == "swa":
            kv += 2 * cfg.n_kv_heads * cfg.head_dim * min(ctx_len, cfg.window or ctx_len)
        elif mixer == "ssm":
            kv += cfg.n_heads * cfg.ssm_headdim * cfg.ssm_state * 2  # fp32 state r/w
        elif mixer == "rec":
            kv += cfg.lru_width * 2
    return c.params_active * dtype_bytes + batch * kv * dtype_bytes


# ---------------------------------------------------------------------------
# Analytic HBM traffic (per chip) of a kernelized step: the reference
# package's first-principles model, copied term for term so both packages
# give the same figures (score and state tiles stay on chip; assumptions
# inline). It models a fused, sharded deployment, not the port's eager step.
# ---------------------------------------------------------------------------


def _attn_kv_traffic(cfg: ModelConfig, tokens_loc: float, seq: int,
                     block_q: int = 512, dtype_bytes: int = 2) -> float:
    """Flash-attention HBM traffic: K/V re-streamed once per q-block."""
    total = 0.0
    plen = len(cfg.pattern)
    n_units, rem = divmod(cfg.n_layers, plen)
    layer_list = list(cfg.pattern) * n_units + list(cfg.pattern[:rem])
    for mixer, _ in layer_list:
        if mixer not in ("attn", "swa"):
            continue
        ctx = seq if mixer == "attn" else min(seq, cfg.window or seq)
        kv_bytes = tokens_loc * (ctx / seq) * 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
        n_q_blocks = max(1, seq // block_q)
        # causal: on average half the KV range is visited per q block
        total += kv_bytes * n_q_blocks * (0.5 if mixer == "attn" else 1.0)
    return total


def _layer_act_traffic(cfg: ModelConfig, tokens_loc: float, tp: int,
                       dtype_bytes: int = 2) -> float:
    """Per-pass matmul-output writes within one decoder pass (all layers).

    ~6 tensor-sized intermediates hit HBM per layer on TPU after fusion
    (qkv out, attn out, 2 ffn hidden (sharded /tp), ffn out, residual).
    """
    d = cfg.d_model
    widest_ff = max(cfg.d_ff, cfg.moe_d_ff * cfg.top_k)
    per_layer = tokens_loc * dtype_bytes * (4 * d + 2 * widest_ff / tp)
    return cfg.n_layers * per_layer


def train_hbm_bytes_per_chip(
    cfg: ModelConfig, seq: int, batch: int, tp: int = 16, dp: int = 16,
    dtype_bytes: int = 2,
) -> float:
    """One train step, full remat, SGD-momentum (fp32 mu), bf16 params."""
    c = count(cfg)
    tokens_loc = seq * batch / dp
    p_loc = c.params_total / tp  # traffic view: each chip touches its TP shard
    # weights: fwd read + remat read + bwd read (bf16) ; grad write+read (fp32),
    # momentum read+write (fp32), param read+write (bf16)
    w = p_loc * (3 * dtype_bytes + 8 + 8 + 2 * dtype_bytes)
    # activation carries saved across the unit scan (write fwd, read bwd)
    acts = 2 * cfg.n_layers * tokens_loc * cfg.d_model * dtype_bytes
    # within-layer intermediates: fwd + remat-fwd + bwd ~ 3 passes
    inner = 3 * _layer_act_traffic(cfg, tokens_loc, tp, dtype_bytes)
    attn = 2 * _attn_kv_traffic(cfg, tokens_loc, seq, dtype_bytes=dtype_bytes)
    logits = 2 * tokens_loc * (cfg.n_codebooks * cfg.vocab_size / tp) * 4
    return w + acts + inner + attn + logits


def prefill_hbm_bytes_per_chip(
    cfg: ModelConfig, seq: int, batch: int, tp: int = 16, dp: int = 16,
    dtype_bytes: int = 2,
) -> float:
    c = count(cfg)
    tokens_loc = seq * batch / dp
    w = (c.params_total / tp) * dtype_bytes
    inner = _layer_act_traffic(cfg, tokens_loc, tp, dtype_bytes)
    attn = _attn_kv_traffic(cfg, tokens_loc, seq, dtype_bytes=dtype_bytes)
    logits = tokens_loc * (cfg.n_codebooks * cfg.vocab_size / tp) * 4
    return w + inner + attn + logits


def decode_hbm_bytes_per_chip(
    cfg: ModelConfig, ctx_len: int, batch: int, tp: int = 16, dp: int = 16,
    dtype_bytes: int = 2,
) -> float:
    """One decode step: TP-sharded weight read + this chip's KV/state slice.

    The cache is batch-sharded over DP (when batch divides) and head/width- or
    sequence-sharded over TP, so each chip reads cache_total/(dp_eff * tp).
    """
    total = decode_hbm_bytes(cfg, ctx_len, batch, dtype_bytes)
    params_part = count(cfg).params_active * dtype_bytes
    cache_part = total - params_part
    dp_eff = dp if batch % dp == 0 else 1
    return params_part / tp + cache_part / (dp_eff * tp)
