"""Model and execution configuration (counterpart of ``repro/models/config.py``).

:class:`ModelConfig` copies the JAX dataclass field for field; ``dtype`` is
a ``torch.dtype`` and defaults to ``torch.bfloat16``. :class:`ParallelCtx`
is the single-device part of the JAX context: the port has no mesh yet, so
only the SSD chunk length is kept.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

# A layer is (mixer, ffn):
#   mixer: "attn" (full), "swa" (sliding window), "rec" (RG-LRU), "ssm" (Mamba-2)
#   ffn:   "mlp", "moe", or None (mamba2 blocks have no separate FFN)
LayerKind = tuple[str, Any]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerKind, ...] = (("attn", "mlp"),)
    # attention
    rope_theta: float = 1e4
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int | None = None  # sliding-window size for "swa" mixers
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    # rg-lru
    lru_width: int = 0
    # frontend / io
    input_mode: str = "tokens"  # "tokens" | "embeddings" (vlm/audio stubs)
    n_codebooks: int = 1  # musicgen: parallel codebook heads
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scale
    # misc
    mlp_act: str = "swiglu"  # swiglu | geglu | gelu
    norm_type: str = "rms"  # rms | layer
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # which input shapes this arch supports (dry-run cells)
    shapes: tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run long_500k (no full-attention layer)."""
        return all(m != "attn" for m, _ in self.pattern)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ParallelCtx:
    """How a forward/backward pass is executed on one device.

    ``attn_backend`` is the backend of :func:`repro_torch.kernels.ops.attention`
    and :func:`~repro_torch.kernels.ops.ssd`: ``"auto"`` the kernel route
    (the kernel on the card, its plain version on the CPU), ``"xla"`` the
    blockwise / chunked route, which autograd goes through (the training
    step's). ``block_kv`` is the KV block of the blockwise route (``min(block_kv,
    S)``); ``ssd_chunk`` the chunk length of the SSD scan (``min(ssd_chunk,
    S)`` is used, and must divide the sequence length). ``mesh`` and
    ``dp_axes`` are JAX's; the port runs with ``mesh=None``.
    """

    mesh: Any = None
    dp_axes: tuple[str, ...] = ()
    attn_backend: str = "auto"
    block_kv: int = 512
    ssd_chunk: int = 128
