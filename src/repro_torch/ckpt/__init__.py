"""Checkpointing: atomic numpy checkpoints.  Port of ``repro.ckpt``; its
``load_resharded`` (``reshard.py``) places a checkpoint onto a mesh and waits
for the port's distribution layer (ROADMAP.md §1 item 11)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
