"""Checkpoints of the port (``repro/checkpoint``): atomic, validated on read,
async, in the JAX package's on-disk layout (:mod:`.checkpoint`)."""

from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    CheckpointError,
    complete_steps,
    latest_step,
    restore,
    save,
    validate_step_dir,
)

__all__ = ["AsyncCheckpointer", "CheckpointError", "complete_steps", "latest_step",
           "restore", "save", "validate_step_dir"]
