"""Checkpoints of the port in the JAX package's format (twin of `repro.checkpoint`)."""
from repro_torch.checkpoint.manager import (
    CheckpointCorrupt,
    CheckpointManager,
    engine_leaves,
    from_arrays,
    to_arrays,
    train_from_arrays,
    train_to_arrays,
)

__all__ = ["CheckpointCorrupt", "CheckpointManager", "engine_leaves", "from_arrays",
           "to_arrays", "train_from_arrays", "train_to_arrays"]
