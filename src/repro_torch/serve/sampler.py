"""Token samplers.

Port of ``repro.serve.sampler``.  Where the reference takes a PRNG key, the
port takes an explicit ``torch.Generator`` on the logits' device.
"""
from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _categorical(logits: torch.Tensor, rng: torch.Generator) -> torch.Tensor:
    """One draw per row of ``logits`` (..., V) from softmax(logits)."""
    probs = torch.softmax(logits.float(), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=rng).reshape(probs.shape[:-1])


def temperature_sample(logits: torch.Tensor, rng: torch.Generator,
                       temperature: float = 1.0) -> torch.Tensor:
    return _categorical(logits / max(temperature, 1e-4), rng).to(torch.int32)


def top_k_sample(logits: torch.Tensor, rng: torch.Generator, k: int = 40,
                 temperature: float = 1.0) -> torch.Tensor:
    vals, idx = torch.topk(logits, k, dim=-1)
    choice = _categorical(vals / max(temperature, 1e-4), rng)
    return torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)
