"""Checkpoints in the JAX package's layout (:mod:`repro_torch.checkpoint.manager`)."""
from repro_torch.checkpoint.manager import CheckpointManager, flatten_tree, unflatten_tree

__all__ = ["CheckpointManager", "flatten_tree", "unflatten_tree"]
