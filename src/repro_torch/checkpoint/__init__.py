"""Atomic checkpoints of the port, in the reference's on-disk format."""

from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    list_checkpoints,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "list_checkpoints", "load_checkpoint",
           "save_checkpoint"]
