"""ZeRO partitioning: spread replicated state over the data axis.

Port of ``repro.dist.zero``.  ``zero1_state_specs`` takes the
tensor-parallel param specs and additionally shards, over ``data``, the
first dim of each leaf that is still replicated and divides the data-axis
size.  ``zero_layouts`` is the staging policy of the reference's
``launch/cell.py::_build_train``: which tree lives in which layout at each
``cfg.zero_stage``.

ZeRO-3's params live in that layout and are gathered where the model uses
them (the reference: "XLA all-gathers per-layer slices inside the scan").
While the step runs :func:`layerwise`, :func:`layer_list` gives each layer
its slices of the stored leaves and :func:`whole` / :func:`whole_tree`
gather them, an autograd function from the stored shard to the whole
(``model``-local) tensor whose backward sums the whole tensor's gradient
over the data ranks into the shard.  A stacked leaf split on its layer dim
holds each layer whole on one rank: its gather is a broadcast from that
rank, its backward a reduce to it.  Split on an inner dim, a layer's slice
is all-gathered and its gradient reduce-scattered.  So a split leaf's
gradient arrives summed over ``data``.  A leaf its layout keeps whole over
``data`` is not gathered: the step sums its gradient as stage 1 does.  A
split leaf the model reads other than through these would carry this rank's
part of its gradient alone, so :func:`layerwise` raises on leaving for one
that was never gathered.  Outside :func:`layerwise` each is the identity (and
:func:`layer_list` the plain per-layer views).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.launch.mesh import Mesh

from . import collectives
from .sharding import (NamedSharding, P, activation_sharding, current_mesh, param_specs,
                       tree_leaves, tree_map2, tree_map_with_path)

_ctx = threading.local()


def zero1_state_specs(shapes, pspecs, mesh: Mesh):
    if "data" not in mesh.shape or mesh.shape["data"] == 1:
        return pspecs
    dsize = mesh.shape["data"]

    def one(leaf, sh: NamedSharding) -> NamedSharding:
        spec = list(sh.spec) + [None] * (leaf.ndim - len(sh.spec))
        for i, dim in enumerate(leaf.shape):
            if spec[i] is None and dim >= dsize and dim % dsize == 0:
                spec[i] = "data"
                break
        return NamedSharding(mesh, P(*spec))

    return tree_map2(one, shapes, pspecs)


class ZeroLayouts(NamedTuple):
    """Per-tree layouts of a training state at one ZeRO stage."""

    params: Any  # where the fp32 params are stored between steps
    moments: Any  # AdamW's mu and nu
    grads: Optional[Any]  # the reduced grads (None: param_specs, all-reduced)


def zero_layouts(shapes, cfg, mesh: Mesh) -> ZeroLayouts:
    """The reference's ZeRO staging: 1 = optimizer state sharded over data;
    2 = + grads reduce-scattered into that layout; 3 = + fp32 params stored
    in it (gathered where the model uses them, a layer at a time)."""
    pspecs = param_specs(shapes, cfg, mesh)
    zspecs = zero1_state_specs(shapes, pspecs, mesh)
    return ZeroLayouts(
        params=zspecs if cfg.zero_stage >= 3 else pspecs,
        moments=zspecs if cfg.zero_stage >= 1 else pspecs,
        grads=zspecs if cfg.zero_stage >= 2 else None,
    )


def data_dim(sharding: NamedSharding, ndim: int) -> Optional[int]:
    """The dim a layout puts on ``data`` (None: not split over it)."""
    for dim, axes in enumerate(sharding.dim_axes(ndim)):
        if "data" in axes:
            return dim
    return None


class _Gather(torch.autograd.Function):
    """A stored shard -> its whole over ``data`` (see the module docstring):
    ``owner`` set, a broadcast from that data index; else an all-gather on
    ``dim``."""

    @staticmethod
    def forward(ctx, shard, mesh, dim, owner):
        ctx.mesh, ctx.dim, ctx.owner = mesh, dim, owner
        if owner is not None:
            return collectives.broadcast(shard, mesh, "data", owner)
        return collectives.all_gather(shard, mesh, "data", dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, owner = ctx.mesh, ctx.dim, ctx.owner
        if owner is not None:
            return collectives.reduce(g, mesh, "data", owner), None, None, None
        return collectives.reduce_scatter(g, mesh, "data", dim), None, None, None


class LayerSlice(NamedTuple):
    """One layer's part of a stored stacked leaf, as :func:`layer_list`
    hands it to the block: ``shard`` this rank's view (for a leaf split on
    its layer dim, the local layer at the same offset: any view keeps the
    backward on this rank's graph), gathered by :func:`whole`."""

    shard: torch.Tensor
    mesh: Mesh
    dim: Optional[int]
    owner: Optional[int]


class _Scope(NamedTuple):
    leaves: dict  # id -> (stored leaf split over data, its layout, its path)
    gathered: set  # the ids of those the model took through whole / layer_list


def _entry(x):
    """``x``'s (leaf, layout, path) under :func:`layerwise`, marked as
    gathered; None for anything else."""
    scope = getattr(_ctx, "scope", None)
    entry = None if scope is None else scope.leaves.get(id(x))
    if entry is not None:
        scope.gathered.add(id(x))
    return entry


@contextmanager
def layerwise(stored, specs):
    """While the step runs: the stored ZeRO-3 leaves of ``stored`` (the
    tensors the model will be handed) with their layouts ``specs``.  Raises
    on leaving if the model never took a leaf split over ``data`` through
    :func:`whole` or :func:`layer_list`."""
    paths = []
    tree_map_with_path(lambda path, _: paths.append(path), stored)
    scope = _Scope({id(t): (t, sh, path) for path, t, sh in
                    zip(paths, tree_leaves(stored), tree_leaves(specs))
                    if data_dim(sh, t.ndim) is not None}, set())
    prev = getattr(_ctx, "scope", None)
    _ctx.scope = scope
    try:
        yield
    finally:
        _ctx.scope = prev
    missed = [path for key, (_, _, path) in scope.leaves.items() if key not in scope.gathered]
    if missed:
        raise RuntimeError(f"ZeRO-3: the model read the stored shards of {missed} without "
                           "gathering them (dist.zero.whole / layer_list); their gradients "
                           "would hold this rank's part alone")


def in_scope(fn):
    """``fn`` bound to this thread's mesh and ZeRO-3 state, to run under
    them on any thread: a checkpointed block's recompute runs on the
    autograd engine's thread (on the card, a worker thread of the device),
    where neither is set."""
    mesh, scope = current_mesh(), getattr(_ctx, "scope", None)

    def run(*args, **kw):
        prev = getattr(_ctx, "scope", None)
        _ctx.scope = scope
        try:
            with activation_sharding(mesh):
                return fn(*args, **kw)
        finally:
            _ctx.scope = prev

    return run


def whole(x):
    """The whole (``model``-local) tensor of a stored leaf or a
    :class:`LayerSlice` under :func:`layerwise`; anything else as it is."""
    if isinstance(x, LayerSlice):
        return _Gather.apply(x.shard, x.mesh, x.dim, x.owner)
    entry = _entry(x)
    if entry is None:
        return x
    t, sh, _ = entry
    return _Gather.apply(t, sh.mesh, data_dim(sh, t.ndim), None)


def _map(fn, tree):
    """``fn`` over the leaves of a tree of dicts (a param tree)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def whole_tree(tree):
    """:func:`whole` of every leaf of a param tree."""
    if getattr(_ctx, "scope", None) is None:
        return tree
    return _map(whole, tree)


def layer_list(layers) -> list:
    """Every layer's params along the stacked leading axis, views made by
    one ``unbind`` of each leaf (under autograd its backward stacks the
    layers' grads in one op; indexing each layer out adds a zero-filled
    copy of the whole stack per layer).  Under :func:`layerwise` a stored
    leaf split over ``data`` gives each layer a :class:`LayerSlice`, which
    the block gathers."""

    def one(leaf):
        views = leaf.unbind(0)
        entry = _entry(leaf)
        if entry is None:
            return views
        sh = entry[1]
        dim = data_dim(sh, leaf.ndim)
        if dim == 0:  # layer i lives whole on data index i // per
            per = leaf.shape[0]
            return [LayerSlice(views[i % per], sh.mesh, None, i // per)
                    for i in range(per * sh.mesh.shape["data"])]
        return [LayerSlice(v, sh.mesh, dim - 1, None) for v in views]

    split = _map(one, layers)
    first = split
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [_map(lambda parts: parts[i], split) for i in range(len(first))]
