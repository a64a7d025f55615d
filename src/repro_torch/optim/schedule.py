"""LR schedules.  Port of ``repro.optim.schedule``: each returns
``lr(step) -> 0-d float32 tensor`` on the step's device."""
from __future__ import annotations

import math

import torch


def _as_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_with_warmup(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def lr(step):
        step = _as_f32(step)
        warm = base_lr * torch.clamp_max(step / max(warmup, 1), 1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def constant(base_lr: float):
    def lr(step):
        return torch.full((), base_lr, dtype=torch.float32, device=torch.as_tensor(step).device)

    return lr
