"""Elastic resharding: restore a checkpoint saved under mesh A onto mesh B.

Port of ``repro.ckpt.reshard``.  Checkpoints store global arrays, so
resharding is placing each rank's shard by the new mesh's shardings — the
mechanism that lets a job restarted on a different rank count (elastic
scaling, failed-node exclusion) resume from the same checkpoint.
"""
from __future__ import annotations

from typing import Any, Optional

from .manager import CheckpointManager


def load_resharded(
    manager: CheckpointManager,
    like: Any,
    new_shardings: Any,
    step: Optional[int] = None,
) -> tuple[Optional[int], Any]:
    """Restore with placement onto a (possibly different) mesh."""
    return manager.restore(like, step=step, shardings=new_shardings)
