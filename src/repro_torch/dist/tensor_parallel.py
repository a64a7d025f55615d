"""Megatron's tensor parallelism on the ``model`` axis of the current mesh,
for the transformer decoder's params placed by ``param_specs``.

Each helper decides from the global dim the rule sharded (``n_heads``,
``d_ff``, ``padded_vocab``...) by the rule's own divisibility guard, so a dim
the rule left replicated is never reduced.  With no current mesh, or a
``model`` axis of 1, each is the identity (or the whole range): one device
runs the model unchanged.

Under autograd each collective has Megatron's conjugate in the backward:
:func:`reduce` (a row-parallel exit, "g") sums forward and passes the
gradient through; :func:`copy` (a column-parallel entry, "f") passes forward
and sums the gradient; :func:`gather_last` gathers forward and keeps this
rank's slice of the gradient.  What holds them right: on every rank a
replicated activation carries the whole gradient, so each replicated leaf's
gradient is the one-device gradient and each sharded leaf's is its slice.
A replicated tensor read only in part on a rank (whole KV heads read by the
local query heads, a bias sliced to the local heads) takes its own
:func:`copy` before the partial read.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import collectives
from .sharding import current_mesh


def _tp_mesh():
    mesh = current_mesh()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return mesh


def size() -> int:
    mesh = _tp_mesh()
    return 1 if mesh is None else mesh.shape["model"]


def sharded(dim: int) -> bool:
    """Whether the rule splits a dim of global size ``dim`` on ``model``."""
    n = size()
    return n > 1 and dim % n == 0


def local_range(dim: int) -> tuple:
    """This rank's [lo, hi) of a global dim of size ``dim``: all of it when
    the rule keeps it whole."""
    if not sharded(dim):
        return 0, dim
    n, i = size(), _tp_mesh().index("model")
    return i * (dim // n), (i + 1) * (dim // n)


def refuse(what: str) -> None:
    """Raise before any collective where ``what``, which has no
    tensor-parallel forward, would run on a ``model`` axis > 1."""
    if _tp_mesh() is not None:
        raise NotImplementedError(
            f"{what} has no tensor-parallel forward: its params would be sharded while it "
            "computes as if whole; a `model` axis > 1 waits (ROADMAP.md §1 item 11b)")


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        return collectives.all_reduce(y, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g, ctx.mesh, "model"), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        ctx.lo, ctx.n = mesh.index("model") * y.shape[-1], y.shape[-1]
        return collectives.all_gather(y, mesh, "model", dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.lo, ctx.n), None


def reduce(y: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over the ``model`` ranks of a row-parallel partial ``y``,
    when the contracted dim (global size ``dim``) is sharded; the gradient
    passes through to each rank's partial."""
    if not sharded(dim):
        return y
    return _Reduce.apply(y, _tp_mesh())


def copy(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` entering a computation split on a dim of global size ``dim``:
    itself forward, its gradient summed over the ``model`` ranks (each
    rank's part computes a partial one) when that dim is sharded."""
    if not sharded(dim) or not torch.is_grad_enabled():
        return x
    return _Copy.apply(x, _tp_mesh())


def gather_last(y: torch.Tensor, dim: int) -> torch.Tensor:
    """The ``model`` ranks' last-dim slices of ``y`` gathered, when that dim
    (global size ``dim``) is sharded; the gradient keeps this rank's slice
    (every rank holds the same gradient of the gathered tensor)."""
    if not sharded(dim):
        return y
    return _GatherLast.apply(y, _tp_mesh())


def kv_heads_for_local_q(n_heads: int, n_kv_heads: int, kv_local: int) -> Optional[object]:
    """Which of the ``kv_local`` KV heads a rank holds its local query heads
    read, where the query heads are split and the KV heads kept whole
    (``n_kv_heads`` does not divide the axis): global query head ``h`` reads
    KV head ``h // (n_heads // n_kv_heads)``, which the local grouping
    (local head ``j`` reads KV head ``j // g``) does not give.  None when the
    local grouping is right; else a ``slice`` of the KV heads when the local
    heads read a contiguous run in equal groups, else an index tensor (one
    KV head per query head)."""
    if not sharded(n_heads) or kv_local != n_kv_heads or n_kv_heads == 1:
        return None
    lo_q, hi_q = local_range(n_heads)
    group = n_heads // n_kv_heads
    idx = [h // group for h in range(lo_q, hi_q)]
    lo, hi = idx[0], idx[-1] + 1
    local_group = len(idx) // (hi - lo)
    if len(idx) % (hi - lo) == 0 and idx == [lo + j // local_group for j in range(len(idx))]:
        return slice(lo, hi)
    return torch.tensor(idx)
