"""Pointer-chase pattern generation + latency-curve analysis (Mei & Chu [9],
paper §3.1/3.8).

``single_cycle_permutation`` (Sattolo) gives the random-walk pattern that
defeats prefetchers.  ``detect_plateaus`` reads cache-level sizes and
latencies off the measured curve exactly the way Fig 3.5 / Tab 3.1 were
produced.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def single_cycle_permutation(n: int, seed: int = 0) -> np.ndarray:
    """Random permutation with one n-cycle (Sattolo's algorithm).

    Bit for bit the permutation of ``repro.core.pchase``: all swap partners
    come from one ``rng.integers`` call over the descending bounds (the same
    draws, in order, as one scalar call per step), and the swaps run on a
    Python list, which is several times faster than on a numpy array.
    """
    rng = np.random.default_rng(seed)
    partners = rng.integers(0, np.arange(n - 1, 0, -1)).tolist() if n > 1 else []
    items = list(range(n))
    for i, j in zip(range(n - 1, 0, -1), partners):
        items[i], items[j] = items[j], items[i]
    # items is now a cyclic ordering; build successor map
    order = np.asarray(items, dtype=np.int64)
    perm = np.empty(n, dtype=np.int32)
    perm[order[:-1]] = order[1:]
    perm[order[-1]] = order[0]
    return perm


@dataclass(frozen=True)
class Plateau:
    latency: float  # representative latency of this level
    start_size: int  # first footprint on the plateau
    end_size: int  # last footprint before the next transition


def detect_plateaus(
    sizes: np.ndarray, lat: np.ndarray, rel_jump: float = 0.30
) -> list[Plateau]:
    """Segment a latency-vs-footprint curve into plateaus.

    A new level starts where latency jumps by more than ``rel_jump`` relative
    to the running plateau median — the transition size is the capacity of
    the previous level (paper Fig 3.6 methodology).
    """
    sizes = np.asarray(sizes)
    lat = np.asarray(lat, dtype=np.float64)
    if sizes.shape != lat.shape or sizes.ndim != 1:
        raise ValueError(f"sizes {sizes.shape} and latencies {lat.shape} must be matching 1-D")
    plateaus: list[Plateau] = []
    seg_start = 0
    seg_vals = [lat[0]]
    for i in range(1, len(sizes)):
        base = float(np.median(seg_vals))
        if lat[i] > base * (1.0 + rel_jump):
            plateaus.append(Plateau(base, int(sizes[seg_start]), int(sizes[i - 1])))
            seg_start = i
            seg_vals = [lat[i]]
        else:
            seg_vals.append(lat[i])
    plateaus.append(Plateau(float(np.median(seg_vals)), int(sizes[seg_start]), int(sizes[-1])))
    return plateaus


def capacities_from_plateaus(plateaus: list[Plateau]) -> list[int]:
    """Detected capacity of each level = footprint where the next level begins."""
    return [p.end_size for p in plateaus[:-1]]
