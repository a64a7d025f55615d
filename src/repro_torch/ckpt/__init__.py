"""Checkpointing: atomic numpy checkpoints and their resharded restore.
Port of ``repro.ckpt``."""
from .manager import CheckpointManager
from .reshard import load_resharded

__all__ = ["CheckpointManager", "load_resharded"]
