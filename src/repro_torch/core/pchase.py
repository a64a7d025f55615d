"""Pointer-chase pattern generation + latency-curve analysis (Mei & Chu [9],
paper §3.1/3.8).

``single_cycle_successors`` (Sattolo) gives the random-walk pattern that
defeats prefetchers.  ``detect_plateaus`` reads cache-level sizes and
latencies off the measured curve exactly the way Fig 3.5 / Tab 3.1 were
produced.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def single_cycle_successors(n: int, seed: int = 0, device="cpu") -> torch.Tensor:
    """Random permutation with one n-cycle (Sattolo's algorithm), as an int32
    tensor on ``device``: entry i is the index the walk loads after i.

    Bit for bit the permutation of ``repro.core.pchase``: the swap partners
    come from one ``rng.integers`` call over the descending bounds (the same
    draws, in order, as one scalar call per step).  The swaps are not run one
    by one.  Step i (n-1 down to 1) swaps positions i and j_i < i, and no
    later step touches position i, so its final value is what position j_i
    holds just before step i: the value brought there by the latest earlier
    step k > i with j_k = j_i (what position k held just before step k), or
    j_i itself.  What position k holds just before step k follows the same
    rule from the first step that targets k (a larger index), so it is found
    by pointer jumping toward the largest index; a sort groups the steps by
    target.  This is O(n log n) in tensor ops, which run on the card as well.
    """
    dev = torch.device(device)
    if n <= 1:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, np.arange(n - 1, 0, -1))  # partners of steps n-1 .. 1
    part = torch.from_numpy(draws[::-1].copy()).to(dev)  # part[i - 1]: partner of step i
    tgt, step = torch.sort(part, stable=True)  # steps grouped by target, ascending
    step += 1
    same = tgt[1:] == tgt[:-1]
    # the next larger step with the same target as step i (-1: none)
    nxt = torch.full((n,), -1, dtype=torch.int64, device=dev)
    nxt[step[:-1][same]] = step[1:][same]
    # first[p]: the first step that targets position p, or p if none does;
    # jumping to the end of that chain gives what p holds before its own step
    lead = torch.ones(n - 1, dtype=torch.bool, device=dev)
    lead[1:] = ~same
    held = torch.arange(n, device=dev)
    held[tgt[lead]] = step[lead]
    while True:
        jumped = held[held]
        if torch.equal(jumped, held):
            break
        held = jumped
    items = torch.empty(n, dtype=torch.int64, device=dev)  # the cyclic ordering
    items[1:] = torch.where(nxt[1:] >= 0, held[nxt[1:].clamp_min(0)], part)
    items[0] = held[0]  # position 0 takes no step: what the last swap into it left
    perm = torch.empty(n, dtype=torch.int32, device=dev)  # successor map
    perm[items[:-1]] = items[1:].int()
    perm[items[-1]] = items[0].int()
    return perm


def single_cycle_permutation(n: int, seed: int = 0) -> np.ndarray:
    """:func:`single_cycle_successors` on the host, as a numpy int32 array."""
    return single_cycle_successors(n, seed).numpy()


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
