"""Megatron's tensor-parallel forward on the ``model`` axis of the current
mesh, for the transformer decoder's params placed by ``param_specs``.

Each helper decides from the global dim the rule sharded (``n_heads``,
``d_ff``, ``padded_vocab``...) by the rule's own divisibility guard, so a dim
the rule left replicated is never reduced.  With no current mesh, or a
``model`` axis of 1, each is the identity (or the whole range): one device
runs the model unchanged.

Under autograd a ``model`` axis > 1 raises ``NotImplementedError`` before
any collective: training on a ``model`` axis needs the conjugate collectives
in the backward (ROADMAP.md §1 item 11b).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import collectives
from .sharding import current_mesh, tree_leaves


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


def refuse_autograd(params) -> None:
    """Raise before any collective when a ``model`` axis > 1 would run under
    autograd."""
    if (_tp_mesh() is not None and torch.is_grad_enabled()
            and any(p.requires_grad for p in tree_leaves(params))):
        raise NotImplementedError(
            "training on a `model` axis needs the conjugate collectives in the "
            "backward (ROADMAP.md §1 item 11b); run the model axis under no_grad")


def reduce(y: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over the ``model`` ranks of a row-parallel partial ``y``,
    when the contracted dim (global size ``dim``) is sharded."""
    if not sharded(dim):
        return y
    return collectives.all_reduce(y, _tp_mesh(), "model")


def gather_last(y: torch.Tensor, dim: int) -> torch.Tensor:
    """The ``model`` ranks' last-dim slices of ``y`` gathered, when that dim
    (global size ``dim``) is sharded."""
    if not sharded(dim):
        return y
    return collectives.all_gather(y, _tp_mesh(), "model", dim=-1)


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
