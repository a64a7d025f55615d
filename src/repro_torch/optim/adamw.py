"""AdamW with the reference's state layout and arithmetic.

Port of ``repro.optim.adamw``.  ``AdamWState(step, mu, nu)`` holds a 0-d
int32 step and two param-shaped trees, so a checkpoint of it carries the
reference's key strings.  The reference's update is functional and relies on
donated buffers to update in place; here ``update`` writes the moments in
place and turns the grads' own storage into the updates, and ``apply`` adds
them to the params in place, all under ``torch.no_grad()``: a step holds
params, grads, ``mu`` and ``nu`` and one leaf's temporaries, never a second
copy of a tree.  The arithmetic is the reference's, operation for operation:
bias correction by ``1 - b**step``, ``mhat / (sqrt(vhat) + eps)``, decoupled
``weight_decay * p`` and ``-lr * u``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Any  # first moment (param tree)
    nu: Any  # second moment (param tree)


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        leaf = tree_leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr) -> tuple[Any, AdamWState]:
        """The updates ``-lr * u`` and the advanced state.  The moments and
        the step advance in place; the grads are consumed: each update is
        written into its grad's storage, and the returned tree holds them."""
        state.step.add_(1)
        step = state.step.float()
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step
        c2 = 1.0 - b2 ** step
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
                              tree_leaves(params)):
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square().mul_(1 - b2))
            denom = (v / c2).sqrt_().add_(self.eps)
            torch.div(m, c1, out=g)  # mhat, in the grad's storage
            g.div_(denom)
            if self.weight_decay:
                g.add_(self.weight_decay * p)
            g.mul_(-lr)
        return grads, state

    @torch.no_grad()
    def apply(self, params, updates):
        """``params + updates`` in the params' dtype, in place; returns params."""
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u)
        return params
