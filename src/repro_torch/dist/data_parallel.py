"""Statistics over the global batch on the ``pod``/``data`` axes of the
current mesh.

Under the reference's jitted step a mean over the batch is over the whole
batch, however it is sharded; here each rank holds its share of it.
:func:`batch_mean` turns a rank's mean over its share into the mean over the
global batch.  With no current mesh, or batch axes of size 1, it is the
identity.
"""
from __future__ import annotations

import torch

from . import collectives
from .sharding import current_mesh


def _batch_axes(mesh) -> list:
    return [a for a in ("pod", "data") if mesh is not None and mesh.shape.get(a, 1) > 1]


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        n = 1
        for a in axes:
            x, n = collectives.all_reduce(x, mesh, a), n * mesh.shape[a]
        return x / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the batch ranks of a rank's mean over its equal share
    of the batch: the mean over the global batch.  The gradient passes
    through as it is: each rank keeps its own share of a loss that the step
    then averages over the ranks, so an all-reduce in the backward would
    count the term once for every rank."""
    mesh = current_mesh()
    axes = _batch_axes(mesh)
    if not axes:
        return x
    return _BatchMean.apply(x, mesh, axes)
