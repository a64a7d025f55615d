"""The row a ``cuda`` variant emits in place of its points on a CPU device.

The hand kernels need the card, and no variant quietly measures the plain
version in their place: on the CPU a ``cuda`` variant returns one
``<benchmark>_skipped`` row counting the points it did not run.
"""
from __future__ import annotations

import torch

from ..schema import BenchRecord


def skipped_on_cpu(benchmark: str, points: int, backend: str, device) -> list:
    """``[<benchmark>_skipped row]`` for a ``cuda`` variant off the card, else ``[]``."""
    if backend != "cuda" or torch.device(device).type == "cuda":
        return []
    return [
        BenchRecord(
            name=f"{benchmark}_skipped",
            benchmark=benchmark,
            x=None,
            value=float(points),
            unit="points",
            better="info",
            info=f"the cuda kernels need the card; not run on {device}",
        )
    ]
