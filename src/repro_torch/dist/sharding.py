"""Sharding rules: logical activation axes and name-based parameter specs.

Port of ``repro.dist.sharding``, rule for rule.  The reference is
single-controller GSPMD: one process, and XLA inserts the collectives that a
layout implies.  The port is SPMD on ``torch.distributed``: one process per
rank, each holding its shard as a plain tensor, and the collectives are
explicit (``dist/tensor_parallel.py`` for the model, ``train/step.py`` for
the data-parallel step).

- **Parameter specs**: ``param_specs`` walks a parameter tree and assigns
  Megatron-style tensor-parallel specs by leaf path: vocab-sharded
  embedding/lm_head, head-sharded wq/wk/wv, row-parallel attention/MLP
  ``wo``, column-parallel ``wi*``, expert- or ffn-sharded MoE weights
  (``cfg.moe_shard``).  Stacked layers (a leading layer dim) are handled by
  right-aligning the core spec.  Every axis assignment is
  divisibility-guarded: a dim that does not divide the mesh axis stays
  replicated.
- **Placement**: :func:`shard_tree` is the counterpart of
  ``jax.device_put(tree, shardings)``: it slices this rank's shard out of a
  global tree.  :func:`gather_tree` is its inverse.
- **Activation pinning**: ``activation_sharding(mesh)`` makes ``mesh`` the
  current mesh, which the model's tensor-parallel collectives read.
  ``shard_act`` and ``shard_params`` keep the reference's signatures and are
  identities: under SPMD every rank already holds its part, so there is no
  layout to constrain.  The one pin that moves data, the transformer's
  residual stream on ``("dp", "sp", None)``, is carried out by the model
  itself: ``tp.split_seq`` and the blocks' sequence-parallel entries and
  exits (``dist/tensor_parallel.py``) hold each rank's S slice, split by
  the same guard as :func:`_guarded_spec`.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from math import prod
from typing import Optional

import torch

from repro_torch.launch.mesh import Mesh

from . import collectives

_ctx = threading.local()


class PartitionSpec(tuple):
    """Per-dim mesh axes (``jax.sharding.PartitionSpec``): an axis name, a
    tuple of them, or None (replicated); trailing dims left out are
    replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A spec over a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def dim_axes(self, ndim: int) -> list:
        """Each dim's axes as a tuple (empty when replicated)."""
        spec = list(self.spec) + [None] * (ndim - len(self.spec))
        return [() if a is None else (a if isinstance(a, tuple) else (a,)) for a in spec]


def current_mesh() -> Optional[Mesh]:
    return getattr(_ctx, "mesh", None)


@contextmanager
def activation_sharding(mesh: Mesh):
    """Make ``mesh`` the current mesh while the model runs."""
    prev = getattr(_ctx, "mesh", None)
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = prev


# ---------------------------------------------------------------------------
# logical -> mesh axis resolution
# ---------------------------------------------------------------------------
def _dp_axes(mesh: Mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _resolve(mesh: Mesh, logical: Optional[str]):
    if logical is None:
        return None
    if logical == "dp":
        return _dp_axes(mesh)
    if logical in ("tp", "sp", "ep"):
        return "model" if "model" in mesh.shape else None
    raise ValueError(f"unknown logical axis {logical!r}")


def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return prod(mesh.shape[a] for a in axis)
    return mesh.shape.get(axis, 1)


def _guarded_spec(mesh: Mesh, shape, axes) -> PartitionSpec:
    """Drop any axis assignment whose mesh size doesn't divide the dim."""
    spec = []
    for dim, ax in zip(shape, axes):
        size = _axis_size(mesh, ax)
        spec.append(ax if ax is not None and size > 1 and dim % size == 0 else None)
    return P(*spec)


# ---------------------------------------------------------------------------
# activation pinning
# ---------------------------------------------------------------------------
def shard_act(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Identity.  The reference constrains ``x``'s layout for XLA; under SPMD
    each rank already holds its part of ``x``, so there is nothing to pin.
    Where a pin splits a tensor the program holds whole, the program splits
    it: the reference's ``"sp"`` (``model`` on S of the transformer's
    stream) is ``dist.tensor_parallel.split_seq`` and its pairs."""
    return x


def shard_params(tree, cfg):
    """Identity, for the reason :func:`shard_act` gives: each rank's layer
    params are already its shards."""
    return tree


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
def _core_spec(path: str, cfg) -> tuple:
    """Tensor-parallel spec for a leaf's trailing 'core' dims, by name."""
    if "router" in path:
        return (None, None)  # (d, E): routing probs need the full expert set
    if "moe" in path:  # expert weights (E, d, f) / (E, f, d)
        if getattr(cfg, "moe_shard", "expert") == "expert":
            return ("model", None, None)  # expert parallel
        if "wo" in path:
            return (None, "model", None)  # TP inside each expert, row-parallel
        return (None, None, "model")
    if "embed" in path:
        return ("model", None)  # (V, d) vocab-sharded
    if "lm_head" in path or "unembed" in path:
        return (None, "model")  # (d, V) vocab-sharded logits
    if "attn" in path:
        if "wo" in path:
            return ("model", None, None)  # (h, hd, d) row-parallel on heads
        if any(w in path for w in ("wq", "wk", "wv")):
            return (None, "model", None)  # (d, h|k, hd) head-sharded
        return ()
    if any(w in path for w in ("wi_gate", "wi_up", "in_proj", "w_in")):
        return (None, "model")  # (d, f) column-parallel
    if "mlp" in path and "wi" in path:
        return (None, "model")
    if ("mlp" in path and "wo" in path) or "out_proj" in path or "w_out" in path:
        return ("model", None)  # (f, d) row-parallel
    return ()  # norms, biases, scalars: replicated


def _param_axes(path: str, ndim: int, cfg) -> tuple:
    core = _core_spec(path, cfg)
    if len(core) > ndim:  # e.g. a bias that matched a weight-name substring
        core = core[-ndim:]
    return (None,) * (ndim - len(core)) + tuple(core)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists; a path is
    the leaf's keys joined by ``/``, as the reference's ``_path_str`` joins
    a ``jax.tree_util`` key path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, tuples and lists, in path order."""
    out = []
    tree_map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out


def tree_map2(fn, a, b):
    """``fn(leaf_a, leaf_b)`` over two trees of one structure."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(tree_map2(fn, x, y) for x, y in zip(a, b)))
    if isinstance(a, (tuple, list)):
        return type(a)(tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def param_specs(shapes, cfg, mesh: Mesh):
    """Tree of :class:`NamedSharding` for a parameter tree (tensors of any
    device, ``meta`` included)."""

    def one(path, leaf):
        axes = _param_axes(path, leaf.ndim, cfg)
        return NamedSharding(mesh, _guarded_spec(mesh, leaf.shape, axes))

    return tree_map_with_path(one, shapes)


# ---------------------------------------------------------------------------
# input / output shardings for the launch layer
# ---------------------------------------------------------------------------
def batch_shardings(batch, mesh: Mesh):
    """Batch-dim data-parallel sharding for every input leaf."""
    dp = _dp_axes(mesh)

    def one(_, leaf):
        axes = (dp,) + (None,) * (leaf.ndim - 1)
        return NamedSharding(mesh, _guarded_spec(mesh, leaf.shape, axes))

    return tree_map_with_path(one, batch)


def cache_shardings(cache, cfg, mesh: Mesh):
    """Decode-cache sharding: batch on dp; KV heads on model when divisible.

    Stacked KV caches are (L, B, Smax, K, hd); recurrent-state caches keep
    batch at dim 1 as well — everything else stays replicated.
    """
    dp = _dp_axes(mesh)

    def one(_, leaf):
        axes = [None] * leaf.ndim
        if leaf.ndim >= 2:
            axes[1] = dp
        if leaf.ndim == 5 and leaf.shape[3] == getattr(cfg, "n_kv_heads", -1):
            axes[3] = "model" if "model" in mesh.shape else None
        return NamedSharding(mesh, _guarded_spec(mesh, leaf.shape, tuple(axes)))

    return tree_map_with_path(one, cache)


def paged_cache_shardings(cache, cfg, mesh: Mesh):
    """Paged KV-pool sharding: KV heads on ``model`` when divisible.

    Pool leaves are (L, N_pages, page, K, hd).  The page dim stays
    replicated on purpose: block tables address pages randomly, so sharding
    pages would turn every ``gather_pages`` into a cross-rank gather; the
    tensor-parallel axis for decode is the KV-head dim, matching the
    head-sharded wk/wv that produce the entries.
    """

    def one(_, leaf):
        axes = [None] * leaf.ndim
        if leaf.ndim == 5 and leaf.shape[3] == getattr(cfg, "n_kv_heads", -1):
            axes[3] = "model" if "model" in mesh.shape else None
        return NamedSharding(mesh, _guarded_spec(mesh, leaf.shape, tuple(axes)))

    return tree_map_with_path(one, cache)


def logits_sharding(global_batch: int, vocab_size: int, mesh: Mesh) -> NamedSharding:
    """Output-logits sharding: batch-dim dp, vocab gathered for sampling.

    Rank-agnostic (covers (B, S, V) prefill and (B, V) decode): only dim 0 is
    named, trailing dims are replicated.
    """
    dp = _dp_axes(mesh)
    if dp is not None and global_batch % _axis_size(mesh, dp) != 0:
        dp = None
    return NamedSharding(mesh, P(dp))


# ---------------------------------------------------------------------------
# placement: the counterpart of jax.device_put, and its inverse
# ---------------------------------------------------------------------------
def local_index(sharding: NamedSharding, shape) -> tuple:
    """This rank's slice of a global ``shape`` under ``sharding``: a tuple of
    ``slice``s.  A dim over several axes splits major to minor, as JAX
    splits it."""
    mesh = sharding.mesh
    out = []
    for dim, axes in zip(shape, sharding.dim_axes(len(shape))):
        n = prod(mesh.shape[a] for a in axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {axes} ({n} ranks)")
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + mesh.index(a)
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


def shard_tree(tree, shardings):
    """Each rank's shard of a global tree, as new tensors on the mesh's
    device (``jax.device_put(tree, shardings)``; the tree passed in is left
    as it was)."""

    def one(leaf, sh):
        part = leaf[local_index(sh, leaf.shape)]
        return part.to(sh.mesh.device, copy=True).contiguous()

    return tree_map2(one, tree, shardings)


def gather_tree(tree, shardings):
    """The global tree from every rank's shards (collective: every rank of
    the mesh calls it; each gets the whole tree)."""

    def one(leaf, sh):
        mesh = sh.mesh
        for dim, axes in enumerate(sh.dim_axes(leaf.ndim)):
            for a in reversed(axes):  # the minor axis first
                leaf = collectives.all_gather(leaf, mesh, a, dim)
        return leaf

    return tree_map2(one, tree, shardings)
