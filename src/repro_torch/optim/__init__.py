"""Optimizers of the port (``repro/optim``): SGD with momentum and AdamW on
pytrees of tensors. The error-feedback gradient compression of
``repro/optim/compression.py`` runs only with a data-parallel mesh and
comes with it (ROADMAP A6b)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    get_optimizer,
    global_norm,
    sgd,
    tree_items,
    tree_leaves,
    tree_map,
)

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm", "get_optimizer",
           "global_norm", "sgd", "tree_items", "tree_leaves", "tree_map"]
