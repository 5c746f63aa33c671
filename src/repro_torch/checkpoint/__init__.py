"""Checkpointing (the port of :mod:`repro.checkpoint`): atomic,
manifest-validated ``.npy`` leaves in the reference's on-disk layout, so a
checkpoint written by either package restores in the other."""
from repro_torch.checkpoint.manager import CheckpointManager, tree_flatten

__all__ = ["CheckpointManager", "tree_flatten"]
