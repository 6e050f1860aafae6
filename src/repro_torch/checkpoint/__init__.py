"""Fault-tolerant checkpoints of trees of tensors (counterpart of
``repro.checkpoint``), in the reference's on-disk layout, so that a
directory written by either package is restored by the other."""
from .manager import CheckpointManager, restore_tree, save_tree

__all__ = ["CheckpointManager", "restore_tree", "save_tree"]
