"""The general traffic generator: every request, prompt and batch a run
sends comes from here, from a traffic file's parameters and ``--seed``.

Sizes, and the order in which they are sent, come from the traffic file
alone and are the same for every seed; the seed draws the token ids.  So
two seeds send the same work, and the spread between seeds is the spread of
the system, not of the work.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one purpose (``stream``) of one run's seed."""
    return np.random.Generator(np.random.PCG64([int(seed) % (1 << 63), stream]))


def log_normal_grid(median: float, sigma: float, n: int) -> np.ndarray:
    """``n`` sizes at the midpoints of ``n`` equal-probability bins of the
    log-normal distribution with this median and log-space ``sigma``."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.round(median * np.exp(sigma * z)).astype(np.int64)


def size_grid(d: dict, n: int) -> np.ndarray:
    """A traffic file's size distribution ``d`` as ``n`` stratified sizes,
    clipped to ``[min, max]`` where the file gives them."""
    if d["dist"] != "log_normal":
        raise ValueError(f"unknown size distribution {d['dist']!r}")
    sizes = log_normal_grid(d["median"], d["sigma"], n)
    return np.clip(sizes, d.get("min", 1), d.get("max", np.iinfo(np.int64).max))


# ---------------------------------------------------------------------------
# served requests
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Request:
    index: int
    prompt: list
    max_new_tokens: int


def request_sizes(t: dict) -> list:
    """One block of (prompt tokens, output tokens) pairs: ``block`` prompt
    and output sizes on their stratified grids, paired by a permutation that
    the traffic file fixes (``pairing_seed``), not the run's seed.  Where
    the file gives ``max_len``, an output is cut so that prompt and output
    fit in it."""
    n = t["block"]
    prompts = size_grid(t["prompt_tokens"], n)
    outputs = size_grid(t["output_tokens"], n)
    perm = np.random.Generator(np.random.PCG64(t["pairing_seed"])).permutation(n)
    cap = t.get("max_len")
    return [(int(a), int(b if cap is None else min(b, cap - a)))
            for a, b in zip(prompts, outputs[perm])]


class RequestStream:
    """Requests in sending order: block after block of :func:`request_sizes`,
    each block in an order the traffic file fixes (``pairing_seed``), every
    prompt's ids drawn from the run's seed."""

    def __init__(self, t: dict, seed: int, vocab: int):
        self.sizes = request_sizes(t)
        self.order = np.random.Generator(np.random.PCG64([t["pairing_seed"], 1]))
        self.ids = rng(seed, 2)
        self.vocab = vocab
        self.sent = 0
        self._block: list = []

    def __next__(self) -> Request:
        if not self._block:
            self._block = [self.sizes[i] for i in self.order.permutation(len(self.sizes))]
        n_prompt, n_out = self._block.pop()
        prompt = self.ids.integers(0, self.vocab, n_prompt).tolist()
        req = Request(self.sent, prompt, n_out)
        self.sent += 1
        return req

    def __iter__(self):
        return self


# ---------------------------------------------------------------------------
# prompt batches
# ---------------------------------------------------------------------------
def prompt_batch(t: dict, seed: int, call: int, vocab: int) -> np.ndarray:
    """The ids of prefill call ``call``: (batch, seq) int32, fresh each call."""
    g = np.random.Generator(np.random.PCG64([int(seed) % (1 << 63), 3, call]))
    return g.integers(0, vocab, (t["batch"], t["seq"]), dtype=np.int32)


# ---------------------------------------------------------------------------
# training batches: a frozen copy of the counter-mode synthetic LM stream
# (Zipf-like ids with local structure, any step regenerated alone)
# ---------------------------------------------------------------------------
def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def zipf_tokens(shape: tuple, vocab: int, seed: int, alpha: float = 1.1) -> np.ndarray:
    """Zipf-distributed ids by an inverse CDF over a hashed uniform."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64) + (np.uint64(seed) << np.uint64(32))
    u = (_splitmix64(idx) >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    with np.errstate(invalid="ignore", over="ignore"):  # the stream's own cast, kept as it is
        ranks = np.minimum((u ** (-1.0 / (alpha - 1.0)) - 1.0).astype(np.int64), vocab - 1)
    return ranks.reshape(shape).astype(np.int32)


def train_batch(t: dict, seed: int, step: int, vocab: int) -> dict:
    """Step ``step``'s batch: tokens and next-token targets, (batch, seq)
    int32 each; rows differ from step to step and from row to row."""
    b, s = t["batch"], t["seq"]
    base_seed = (int(seed) % (1 << 31)) ^ (step * 2654435761 % (1 << 31))
    base = zipf_tokens((b, s + 1), vocab, base_seed, t.get("zipf_alpha", 1.1))
    nxt = (base[:, :-1] * t.get("structure", 17) + 1) % vocab
    gate = (base[:, :-1] & 1).astype(bool)
    return {"tokens": base[:, :-1], "targets": np.where(gate, nxt, base[:, 1:]).astype(np.int32)}
