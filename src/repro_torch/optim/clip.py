"""Global-norm gradient clipping.  Port of ``repro.optim.clip``."""
from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (a 0-d tensor)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so their global norm is at most ``max_norm``;
    returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, norm
