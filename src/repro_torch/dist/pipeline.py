"""GPipe pipeline parallelism over a mesh axis.

Port of ``repro.dist.pipeline``.  ``gpipe_apply`` runs ``n_stages``
sequential stages over ``n_micro`` microbatches with the classic GPipe
schedule: each rank owns one stage, activations hop stage -> stage+1 around
the axis ring each step (the reference's ``ppermute``), and the pipeline
drains after ``n_micro + n_stages - 1`` steps.  Bubble steps compute on
garbage but are masked out of the output, so the result equals running the
stages sequentially.  The schedule is differentiable: the ring hop is an
autograd function whose backward sends the gradient the other way, and the
output is replicated by a masked sum whose backward is the identity.  Every
select is a ``torch.where``, so each rank's graph holds every hop and the
ranks' backward hops pair up.
"""
from __future__ import annotations

import torch

from . import collectives
from .sharding import tree_leaves, tree_map_with_path


class _Shift(torch.autograd.Function):
    """Send to the next rank of the ring, receive from the previous one;
    the backward sends the gradient to the previous rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return collectives.shift(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return collectives.shift(g.contiguous(), ctx.mesh, ctx.axis, -1), None, None


class _SumReplicated(torch.autograd.Function):
    """Sum over the axis ranks into a replicated value; as every rank then
    computes the same loss from it, each rank's term gets that loss's
    gradient unchanged (Megatron's ``g`` operator)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return collectives.all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gpipe_apply(stage_fn, params, x: torch.Tensor, mesh, axis: str = "pod"):
    """Apply a pipeline of stages to microbatched input.

    Args:
      stage_fn: ``(stage_params, h) -> h`` for one stage.
      params: this rank's stage: a tree whose leaves have a leading dim of
        1, its slice of the reference's ``n_stages`` dim (``shard_tree``
        with ``P(axis)`` gives it).
      x: ``(n_micro, microbatch, ...)`` input microbatches, on every rank.
      mesh: a bound mesh providing the pipeline axis.
      axis: mesh axis name; its size must equal the stage count.
    """
    n_stages = mesh.shape[axis]
    lead = {leaf.shape[0] * n_stages for leaf in tree_leaves(params)}
    if lead != {n_stages}:
        raise ValueError(f"stage dim {lead} != mesh axis {axis}={n_stages}")
    n_micro = x.shape[0]
    p = tree_map_with_path(lambda _, a: a[0], params)
    sidx, last = mesh.index(axis), n_stages - 1
    first = torch.tensor(sidx == 0, device=x.device)
    recv = torch.zeros_like(x[0])
    ys = []
    for t in range(n_micro + n_stages - 1):
        inp = torch.where(first, x[min(t, n_micro - 1)], recv)
        out = stage_fn(p, inp)
        if t >= last:  # the last stage finishes microbatch t - last
            ys.append(out)
        recv = _Shift.apply(out, mesh, axis)
    y = torch.stack(ys)
    y = torch.where(torch.tensor(sidx == last, device=x.device), y, torch.zeros_like(y))
    return _SumReplicated.apply(y, mesh, axis)
