"""Serve-step factory and greedy decoding (``repro/launch/serve.py``).

Batched single-token decode against the per-layer KV / SSM-state cache of
:func:`repro_torch.models.lm.init_cache`. JAX donates the cache to a jitted
step; here the attention caches are written in place. The mesh shardings
of the JAX module (``serve_shardings``) wait for the port's multi-rank
mesh.

Beside the JAX module's two functions, :func:`teacher_force` feeds given
tokens through the step and keeps every position's logits: the prompt of
:func:`greedy_decode`, and the decode side of a check against the prefill.

    from repro_torch.launch.serve import greedy_decode
    out = greedy_decode(params, cfg, ParallelCtx(), prompt, max_new=64)
"""

from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ParallelCtx


def make_serve_step(cfg: ModelConfig, ctx: ParallelCtx):
    """``step(params, cache, token, pos) -> (logits, cache)``: :func:`lm.serve_step`."""
    def serve_step(params, cache, token, pos: int):
        return lm.serve_step(params, cache, token, pos, cfg, ctx)

    return serve_step


@torch.inference_mode()
def greedy_decode(params, cfg: ModelConfig, ctx: ParallelCtx, prompt_tokens: torch.Tensor,
                  max_new: int, *, step=None, device=None) -> torch.Tensor:
    """Greedy decoding as the JAX loop does it: the prompt (B, S0) fed one
    position at a time (:func:`teacher_force`), then ``max_new`` tokens,
    each the argmax of the last logits. The cache lives on ``device`` (the
    CUDA device unless ``"cpu"`` is asked); ``step`` defaults to
    :func:`make_serve_step`'s. Returns the new tokens (B, max_new) int32."""
    s0 = prompt_tokens.shape[1]
    max_len = s0 + max_new
    step = step or make_serve_step(cfg, ctx)
    logits, cache = teacher_force(params, cfg, ctx, prompt_tokens, max_len=max_len, step=step,
                                  device=device)
    out = []
    cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    for t in range(s0, max_len):
        out.append(cur)
        logits, cache = step(params, cache, cur, t)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.stack(out, dim=1)


@torch.inference_mode()
def teacher_force(params, cfg: ModelConfig, ctx: ParallelCtx, tokens: torch.Tensor, *,
                  cache: dict | None = None, start: int = 0, max_len: int | None = None,
                  step=None, device=None):
    """Feed ``tokens`` (B, S[, CB] ids or (B, S, D) embeddings) through the
    serve step at positions ``start`` .. ``start + S - 1``.

    ``cache`` defaults to a fresh one of ``max_len`` positions (``start +
    S``) on ``device``; ``step`` to :func:`make_serve_step`'s. Returns
    (logits (B, S, V) fp32 [or (B, S, CB, V)], cache).
    """
    s = tokens.shape[1]
    if cache is None:
        cache = lm.init_cache(cfg, tokens.shape[0], max_len or start + s, dtype=cfg.dtype,
                              device=device)
    step = step or make_serve_step(cfg, ctx)
    out = []
    for t in range(s):
        logits, cache = step(params, cache, tokens[:, t], start + t)
        out.append(logits)
    return torch.stack(out, dim=1), cache

