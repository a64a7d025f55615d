"""Megatron's tensor parallelism on the ``model`` axis of the current mesh,
for every family's params placed by ``param_specs``.

Each helper decides from the global dim the rule sharded (``n_heads``,
``d_ff``, ``padded_vocab``...) by the rule's own divisibility guard, so a dim
the rule left replicated is never reduced.  With no current mesh, or a
``model`` axis of 1, each is the identity (or the whole range): one device
runs the model unchanged.

Under autograd each collective has Megatron's conjugate in the backward:
:func:`reduce` (a row-parallel exit, "g") sums forward and passes the
gradient through; :func:`copy` (a column-parallel entry, "f") passes forward
and sums the gradient; :func:`gather` gathers forward and keeps this
rank's slice of the gradient.  What holds them right: on every rank a
replicated activation carries the whole gradient, so each replicated leaf's
gradient is the one-device gradient and each sharded leaf's is its slice.
A replicated tensor read only in part on a rank (whole KV heads read by the
local query heads, a bias sliced to the local heads, a Mamba2 layer's whole
leaves cut to the local heads) takes its own :func:`copy` before the partial
read.  A sum over a split dim that every rank reads whole (a norm over the
split channels) is :func:`sum_split`: summed forward, and its gradient
summed back to each rank's partial.

Sequence parallelism (the transformer's residual stream, which the
reference pins to ``("dp", "sp", None)``, ``"sp"`` being ``model``): where
the rule splits S (``model`` > 1 divides it), each rank holds its S slice
of the stream between sublayers (:func:`split_seq` after the embedding,
its gradient all-gathered).  A sublayer that needs every position gathers
S on entry and hands back the summed S slice on exit (:func:`reduce_seq`,
a reduce-scatter whose gradient all-gathers), Megatron's sequence-parallel
pair.  The entry's backward depends on who reads the gathered tensor:
:func:`copy_seq`, for a computation split on its readers' dim, reduce-
scatters the gradient's partials; :func:`gather_seq`, for a tensor that
also has a whole reader, keeps this rank's slice of the whole gradient and
leaves the split readers their own :func:`copy`.  A replicated leaf read on
the slice alone (a norm's scale) takes :func:`copy`, its gradient summed.
Each is :func:`copy`, :func:`reduce` or the identity where S stays whole.
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


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.dim, ctx.lo, ctx.n = dim, mesh.index("model") * y.shape[dim], y.shape[dim]
        return collectives.all_gather(y, mesh, "model", dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None


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


def gather(y: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """The ``model`` ranks' slices of ``y`` on ``dim`` gathered, when that
    dim (global size ``size``) is sharded; the gradient keeps this rank's
    slice (every rank holds the same gradient of the gathered tensor)."""
    if not sharded(size):
        return y
    return _Gather.apply(y, _tp_mesh(), dim % y.ndim)


def sum_split(partial: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over the ``model`` ranks of ``partial``, this rank's sum over
    its part of a dim of global size ``dim``, where every rank then reads
    the whole sum in its own part of the computation: ``copy(reduce(..))``.
    The reduce alone would hand each partial only this rank's share of the
    sum's gradient; the copy sums the shares first."""
    return copy(reduce(partial, dim), dim)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, partial):
        ctx.mesh, ctx.partial, ctx.n = mesh, partial, x.shape[1]
        return collectives.all_gather(x, mesh, "model", dim=1)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return collectives.reduce_scatter(g, ctx.mesh, "model", dim=1), None, None
        return g.narrow(1, ctx.mesh.index("model") * ctx.n, ctx.n), None, None


class _ScatterSeq(torch.autograd.Function):
    """To this rank's S slice: the sum over the ranks' ``y`` (``summed``) or
    ``y`` itself sliced; the gradient is gathered."""

    @staticmethod
    def forward(ctx, y, mesh, summed):
        ctx.mesh = mesh
        if summed:
            return collectives.reduce_scatter(y, mesh, "model", dim=1)
        n = y.shape[1] // mesh.shape["model"]
        return y.narrow(1, mesh.index("model") * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return collectives.all_gather(g, ctx.mesh, "model", dim=1), None, None


def seq_len(s: int) -> Optional[int]:
    """``s`` where the rule splits a stream of ``s`` positions, else None:
    the ``s`` (or ``seq``) the sequence-parallel helpers and blocks take."""
    return s if sharded(s) else None


def split_seq(x: torch.Tensor) -> torch.Tensor:
    """This rank's S slice of a stream ``x`` (B, S, ...) that every rank
    holds whole, where the rule splits S; its gradient is gathered."""
    if not sharded(x.shape[1]):
        return x
    return _ScatterSeq.apply(x, _tp_mesh(), False)


def gather_seq(x: torch.Tensor, s: Optional[int]) -> torch.Tensor:
    """The whole S (global size ``s``; None: ``x`` is whole, see
    :func:`seq_len`) of this rank's slice ``x`` (B, S/n, ...), for readers
    of which one at least is whole on every rank: its gradient, whole on
    every rank (the split readers take their own :func:`copy`), keeps this
    rank's slice."""
    if s is None:
        return x
    return _GatherSeq.apply(x, _tp_mesh(), False)


def copy_seq(x: torch.Tensor, dim: int, s: Optional[int]) -> torch.Tensor:
    """:func:`copy` of a block input ``x`` (B, S/n, ...) read only by a
    computation split on a dim of global size ``dim``, where S (global size
    ``s``; None: ``x`` is whole) is split: S gathered, and the gradient's
    partials reduce-scattered back to the slice (kept as it is where
    ``dim`` is whole)."""
    if s is None:
        return copy(x, dim)
    return _GatherSeq.apply(x, _tp_mesh(), sharded(dim))


def reduce_seq(y: torch.Tensor, dim: int, s: Optional[int]) -> torch.Tensor:
    """:func:`reduce` of a row-parallel output ``y`` (B, S, ...) into this
    rank's S slice, where S (global size ``s``; None: the stream is whole)
    is split: the partials' sum reduce-scattered (sliced, where the
    contracted dim ``dim`` is whole and ``y`` with it); the gradient is
    gathered."""
    if s is None:
        return reduce(y, dim)
    return _ScatterSeq.apply(y, _tp_mesh(), sharded(dim))


def last_seq(x: torch.Tensor, s: Optional[int]) -> torch.Tensor:
    """The last position (B, 1, ...) of a stream of which ``x`` is this
    rank's S slice (``s`` its global size; None: ``x`` is whole): where S is
    split it lies on the last ``model`` rank, which broadcasts that row
    alone.  Forward only (the prefill's): the broadcast carries no
    gradient."""
    if s is None:
        return x[:, -1:]
    mesh = _tp_mesh()
    return collectives.broadcast(x[:, -1:].contiguous(), mesh, "model", mesh.shape["model"] - 1)


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
