"""Checkpoints of tensor trees (port of ``repro.ckpt``)."""

from .checkpoint import (
    CheckpointManager,
    load_flat,
    load_metadata,
    restore_pytree,
    save_pytree,
)

__all__ = ["CheckpointManager", "load_flat", "load_metadata",
           "restore_pytree", "save_pytree"]
