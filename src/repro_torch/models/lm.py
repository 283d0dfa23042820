"""Language-model wrapper: embeddings, decoder stack, head (``repro/models/lm.py``).

Inputs are token ids (B, S) — or (B, S, n_codebooks) — or precomputed
embeddings (B, S, D) for the stub frontends. :func:`prefill` is the
full-prompt forward; :func:`lm_loss` the training loss (fp32 logits and
cross-entropy) that autograd differentiates; :func:`init_cache` and
:func:`serve_step` the decode step, one token against a per-layer KV /
SSM-state cache.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ops import resolve_device, strict_fp32, widen
from repro_torch.models import transformer as tfm
from repro_torch.models.blocks import ParamTree, apply_norm, init_norm, normal
from repro_torch.models.config import ModelConfig, ParallelCtx


def init_lm(cfg: ModelConfig, seed: int = 0, device=None) -> ParamTree:
    """Random parameters of the JAX package's shapes and distributions.

    Drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (the CUDA device unless ``"cpu"`` or ``"meta"`` is asked), so the values
    differ from JAX's; ``meta`` allocates nothing (shapes and counts only).
    """
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    p = {
        "embed": normal((cfg.vocab_size, cfg.d_model), 0.02, gen, dev, cfg.dtype),
        "decoder": tfm.init_decoder(cfg, gen, dev),
        "final_norm": init_norm(cfg.d_model, cfg.norm_type, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((cfg.d_model, cfg.n_codebooks * cfg.vocab_size),
                              cfg.d_model**-0.5, gen, dev, cfg.dtype)
    return ParamTree(p)


def embed_inputs(params, inputs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token ids (B,S) or (B,S,n_codebooks) -> embeddings; passthrough for stubs."""
    if inputs.dtype in (torch.int32, torch.int64):
        x = params["embed"][inputs]
        if cfg.n_codebooks > 1 and inputs.dim() == 3:
            x = x.sum(dim=2)  # codebook sum
    else:
        x = inputs.to(cfg.dtype)  # stub frontend: precomputed embeddings
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def logits_from_hidden(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """fp32 logits: an fp32-accumulated product of the activation-dtype operands.

    Widening both bf16 operands to fp32 makes every product exact, so the
    fp32 matmul (TF32 off) sums the same products.
    """
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]  # (D, CB*V)
    logits = torch.matmul(widen(x), widen(w))
    if cfg.n_codebooks > 1:
        logits = logits.reshape(x.shape[:-1] + (cfg.n_codebooks, cfg.vocab_size))
    return logits


AUX_KEYS = ("load_balance", "router_z")


def forward(params, inputs: torch.Tensor, cfg: ModelConfig, ctx: ParallelCtx):
    """-> (logits fp32, aux dict).

    On the card it first sets :func:`strict_fp32`: the bf16 projections
    must sum in fp32 whichever constructor made ``params``. The aux losses
    are zero: no ported layer has a router.
    """
    if inputs.is_cuda:
        strict_fp32()
    x = embed_inputs(params, inputs, cfg)
    x = tfm.decoder(x, params["decoder"], cfg, ctx)
    x = apply_norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in AUX_KEYS}
    return logits_from_hidden(params, x, cfg), aux


@torch.inference_mode()
def prefill(params, inputs: torch.Tensor, cfg: ModelConfig, ctx: ParallelCtx) -> torch.Tensor:
    """Prefill forward: logits (B, S, V) fp32 for every prompt position."""
    logits, _ = forward(params, inputs, cfg, ctx)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 0.0) -> torch.Tensor:
    """Mean CE over all positions (and codebooks when present), fp32.

    logits: (..., V) fp32; labels: (...) integer ids.
    """
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = torch.mean(lse - ll)
    if z_loss:
        ce = ce + z_loss * torch.mean(lse**2)
    return ce


def lm_loss(params, batch: dict, cfg: ModelConfig, ctx: ParallelCtx, aux_weight: float = 0.01):
    """batch: {"inputs": ids/embeddings, "labels": ids}. Returns (loss, metrics)."""
    logits, aux = forward(params, batch["inputs"], cfg, ctx)
    ce = cross_entropy(logits, batch["labels"])
    loss = ce + aux_weight * aux["load_balance"] + 1e-3 * aux["router_z"]
    metrics = {"loss": loss, "ce": ce, **aux}
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """The decoder's per-layer caches (zeros) on ``device``: the CUDA
    device unless ``"cpu"`` is asked."""
    return tfm.init_decoder_cache(cfg, batch, max_len, dtype, resolve_device(device))


def serve_step(params, cache: dict, token: torch.Tensor, pos: int, cfg: ModelConfig,
               ctx: ParallelCtx):
    """One decode step: token ids (B,), codebook ids (B, CB) or a stub
    embedding (B, D); ``pos`` the token's position, a Python int.

    Returns (logits (B, V) fp32 [or (B, CB, V)], cache). Attention caches
    are updated in place (the counterpart of JAX's donated cache) and the
    cache is returned all the same. On the card it first sets
    :func:`strict_fp32`, as :func:`forward` does.
    """
    if token.is_cuda:
        strict_fp32()
    if token.dtype in (torch.int32, torch.int64) and cfg.n_codebooks == 1:
        inp = token[:, None]
    else:  # codebook ids or a stub embedding
        inp = token[:, None, :]
    x = embed_inputs(params, inp, cfg)
    x, cache = tfm.decoder_step(x, params["decoder"], cfg, cache, pos, ctx)
    x = apply_norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    return logits_from_hidden(params, x, cfg)[:, 0], cache
