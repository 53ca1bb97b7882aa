"""Atomic, checksummed checkpoints of trees of tensors."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
