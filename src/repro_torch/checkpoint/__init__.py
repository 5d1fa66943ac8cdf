"""Fault-tolerant checkpointing (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import (CheckpointManager, restore_tree,
                                         save_tree)

__all__ = ["CheckpointManager", "save_tree", "restore_tree"]
