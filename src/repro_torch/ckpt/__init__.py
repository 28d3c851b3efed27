"""Atomic, async checkpoints of the port (:mod:`.checkpoint`), in the
reference's on-disk layout."""

from .checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
