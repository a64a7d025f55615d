"""Deterministic synthetic LM data.

Port of ``repro.data.synth``, which is numpy only: the port keeps its own
copy, and ``SyntheticLM.batch_at(step)`` equals the reference's bit for bit.

Tokens are a counter-mode hash of (seed, step, position): any batch for any
step can be regenerated without consuming an RNG stream — the property that
makes fault-tolerant resume exact (skip-ahead is O(1), no replay).

The marginal distribution is Zipf-like (real-vocab shape) and the sequence
has local structure (next token depends on the previous one) so models can
actually reduce loss on it — the end-to-end example trains against this.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def zipf_tokens(shape: tuple, vocab: int, seed: int, alpha: float = 1.1) -> np.ndarray:
    """Zipf-distributed tokens via inverse-CDF over a hashed uniform."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64) + (np.uint64(seed) << np.uint64(32))
    u = (_splitmix64(idx) >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    # approximate Zipf inverse CDF: rank ~ u^(-1/(alpha-1)) truncated
    ranks = np.minimum(
        (u ** (-1.0 / (alpha - 1.0)) - 1.0).astype(np.int64), vocab - 1
    )
    return ranks.reshape(shape).astype(np.int32)


@dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: int = 17  # mixing multiplier for local structure

    def batch_at(self, step: int) -> dict:
        """Batch for ``step`` — pure function of (seed, step)."""
        b, s = self.global_batch, self.seq_len
        base = zipf_tokens((b, s + 1), self.vocab_size, self.seed ^ (step * 2654435761 % (1 << 31)))
        # inject predictable structure: with p~0.5, next = f(prev)
        nxt = (base[:, :-1] * self.structure + 1) % self.vocab_size
        gate = (base[:, :-1] & 1).astype(bool)
        tokens = base[:, :-1]
        targets = np.where(gate, nxt, base[:, 1:]).astype(np.int32)
        return {"tokens": tokens, "targets": targets}
