"""A plain float32 training step of the MoE decoder: the loss and its
gradients by autograd, clipping to a global norm, and AdamW, with the
hyper-parameters of the traffic file."""
from __future__ import annotations

import math

import torch

from . import moe_lm
from .common import Numerics, moe_capacity


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr``, then a cosine decay to ``min_frac`` of it
    at ``total`` steps (step 0 first)."""
    base, warm, total = opt["lr"], opt["warmup"], opt["total"]
    if step < warm:
        return base * min(step / max(warm, 1), 1.0)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * (opt["min_frac"] + (1 - opt["min_frac"]) * 0.5 * (1 + math.cos(math.pi * frac)))


def run(num: Numerics, params: dict, batches: list, m: dict, opt: dict, on_step) -> None:
    """Train ``params`` (a dict of float32 leaves, updated in place) on
    ``batches``, one step each.  ``on_step(i, loss, grads)`` sees each
    step's loss and its clipped gradients before the update."""
    leaves = _leaves(params)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    for i, batch in enumerate(batches):
        cap = moe_capacity(batch["tokens"].shape[1], m["experts_per_token"],
                           m["capacity_factor"], m["n_experts"])
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = moe_lm.loss(num, params, batch, m, cap)
            grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        norm = torch.sqrt(sum(torch.sum(g.square()) for g in grads))
        scale = min(1.0, opt["clip"] / max(float(norm), 1e-9))
        grads = [g * scale for g in grads]
        on_step(i, float(loss.detach()), grads)
        lr, t = lr_at(opt, i), i + 1
        with torch.no_grad():
            for p, g, m1, v1 in zip(leaves, grads, mu, nu):
                m1.mul_(b1).add_(g, alpha=1 - b1)
                v1.mul_(b2).add_(g.square(), alpha=1 - b2)
                upd = (m1 / (1 - b1 ** t)) / ((v1 / (1 - b2 ** t)).sqrt() + eps)
                p.sub_(lr * (upd + wd * p))
        del grads


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]
