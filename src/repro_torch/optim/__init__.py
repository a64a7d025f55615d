"""Optimizer substrate: AdamW, schedules, clipping.

Port of ``repro.optim``.  The state mirrors the param tree and is updated in
place (the counterpart of the reference's donated buffers)."""
from .adamw import AdamW, AdamWState
from .clip import clip_by_global_norm, global_norm
from .schedule import constant, cosine_with_warmup

__all__ = ["AdamW", "AdamWState", "cosine_with_warmup", "constant", "clip_by_global_norm",
           "global_norm"]
