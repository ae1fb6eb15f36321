"""Checkpoints of nested dicts of tensors, in the reference's on-disk format."""
from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          restore, save)

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]
