"""Train step: loss -> grads (optionally microbatched) -> clip -> AdamW.

Port of ``repro.train.step``.  Grads come from autograd (the reference's
``jax.value_and_grad``); microbatching accumulates them in fp32 (the
reference's ``lax.scan``); remat inside the model bounds per-layer memory.
The step updates the params and the optimizer state in place (the
reference's jitted step donates them), so the ``TrainState`` it returns
holds the tensors it was given.  The training path is plain torch: the
models train on ``attn_impl="blockwise"`` and ``ssm_impl="xla"``, as the
reference's do, and a hand kernel under autograd raises
(``kernels/api.py``), as the reference's Pallas kernels have no backward.

Distribution (``state_shardings``, from ``dist.zero_layouts`` over a mesh
of ``pod``/``data`` and ``model`` axes): the reference jits its step with
the state and batch shardings and XLA inserts the collectives; here each
rank runs the step on its shards, under the mesh (``activation_sharding``),
and the collectives are explicit.  Each rank takes its share of every
microbatch of the global batch (the reference splits the global batch into
microbatches, each sharded over the batch axes); the model's
tensor-parallel collectives and their conjugates act on ``model``.  The
grads are summed over the ``pod``/``data`` ranks and divided by their
number, reduce-scattered into the ZeRO layout when ``grad_shardings`` is set
(ZeRO-2); AdamW updates the moments in their layout (ZeRO-1) leaf by leaf on
the local shards, with the clip taking the global norm over every shard;
params stored whole over ``data`` go back to their layout by an all-gather.
ZeRO-3 params stay in their layout: the model gathers each where it uses it,
a layer at a time (``dist.zero.layerwise``), and the grads of those split
over ``data`` arrive summed over it.  Microbatches accumulate the local
grads, reduced once (ZeRO-3's split leaves in the backward of each).
"""
from __future__ import annotations

import contextlib
from math import prod
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import timing
from repro_torch.dist import collectives, zero
from repro_torch.dist.sharding import activation_sharding, batch_shardings, local_index, tree_map2
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import AdamW, AdamWState, clip_by_global_norm


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def _unflatten_like(tree, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def value_and_grad(loss_fn: Callable, params, batch) -> tuple:
    """(loss, grads): the loss detached, the grads a tree shaped as
    ``params`` (zeros for a leaf the loss does not reach, as JAX gives)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), _unflatten_like(params, grads)


def _loss_and_grads(loss_fn: Callable, params, batch, microbatches: int) -> tuple:
    """The batch's mean loss and grads, accumulated in fp32 over
    ``microbatches`` equal splits when more than one."""
    if microbatches == 1:
        return value_and_grad(loss_fn, params, batch)

    def split(x, i):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch of {b} does not split into {microbatches} microbatches")
        return x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))[i]

    loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    for i in range(microbatches):
        mb = {k: split(v, i) for k, v in batch.items()}
        l, g = value_and_grad(loss_fn, params, mb)
        loss = loss + l
        for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
            acc.add_(gi.float())
        del g
    loss = loss / microbatches
    for acc in tree_leaves(grads):
        acc.div_(microbatches)
    return loss, grads


def make_train_step(
    loss_fn: Callable,  # (params, batch) -> scalar
    optimizer: AdamW,
    lr_fn: Callable,  # step -> lr
    microbatches: int = 1,
    clip_norm: float = 1.0,
    grad_shardings=None,  # ZeRO-2: reduce-scatter the grads into this layout
    state_shardings=None,  # a TrainState of layouts: the data-parallel step
):
    """Returns step(state, batch) -> (state, metrics).  With
    ``state_shardings`` (``TrainState(params=layouts.params,
    opt=AdamWState(step=None, mu=layouts.moments, nu=layouts.moments))`` of
    ``dist.zero_layouts``) the state holds this rank's shards and the step
    is data-parallel over the layouts' mesh (see the module docstring);
    every rank calls it with the same global batch."""
    if state_shardings is not None:
        return _data_parallel_step(loss_fn, optimizer, lr_fn, microbatches, clip_norm,
                                   grad_shardings, state_shardings)
    if grad_shardings is not None:
        raise ValueError("grad_shardings (ZeRO-2) needs state_shardings, the layouts of the "
                         "state it is sharded with")

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params, opt_state = state
        dev = tree_leaves(params)[0].device
        with timing.span("train.step"):
            with timing.span("train.forward_backward", device=dev):
                loss, grads = _loss_and_grads(loss_fn, params, batch, microbatches)
            with timing.span("train.clip", device=dev):
                grads, gnorm = clip_by_global_norm(grads, clip_norm)
            with timing.span("train.optimizer", device=dev):
                lr = lr_fn(opt_state.step)
                updates, opt_state = optimizer.update(grads, opt_state, params, lr)
                params = optimizer.apply(params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params, opt_state), metrics

    return step


def _rank_batch(batch, mesh, microbatches: int):
    """This rank's rows of the global batch, microbatch by microbatch: its
    local microbatch i is its share of the global batch's microbatch i."""
    first = {k: v[:v.shape[0] // microbatches] for k, v in batch.items()}

    def one(x, sh):
        if x.shape[0] % microbatches:
            raise ValueError(f"batch of {x.shape[0]} does not split into {microbatches} "
                             "microbatches")
        split = x.reshape(microbatches, x.shape[0] // microbatches, *x.shape[1:])
        part = split[(slice(None),) + local_index(sh, split.shape[1:])]
        return part.reshape(-1, *x.shape[1:]).to(mesh.device, copy=True).contiguous()

    return tree_map2(one, batch, batch_shardings(first, mesh))


def _data_parallel_step(loss_fn, optimizer, lr_fn, microbatches, clip_norm, grad_shardings,
                        state_shardings):
    pstore, mspecs = state_shardings.params, state_shardings.opt.mu
    mesh = tree_leaves(mspecs)[0].mesh
    dp = [a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1]
    n_dp = prod(mesh.shape[a] for a in dp)
    layerwise = any(zero.data_dim(sh, len(sh.spec)) is not None for sh in tree_leaves(pstore))

    def dp_mean(g, sh, over_data=True):
        """The mean of ``g`` over the dp ranks, in ``sh``'s ZeRO layout
        (whole when ``sh`` is None or keeps the leaf whole); ``over_data``
        False: ``g`` is summed over ``data`` already."""
        if "pod" in dp:
            g = collectives.all_reduce(g, mesh, "pod")
        dim = None if sh is None else zero.data_dim(sh, g.ndim)
        if "data" in dp and over_data:
            g = (collectives.reduce_scatter(g, mesh, "data", dim) if dim is not None
                 else collectives.all_reduce(g, mesh, "data"))
        return g.div_(n_dp)

    def moments_view(t, sh, whole: bool):
        """``t`` in the moments' layout: this rank's slice (a view) of a
        leaf whole over ``data`` that the layout splits over it."""
        dim = zero.data_dim(sh, t.ndim)
        if not whole or dim is None:
            return t
        n = t.shape[dim] // mesh.shape["data"]
        return t.narrow(dim, mesh.index("data") * n, n)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        with timing.span("train.step"):
            stored, opt_state = state
            dev = mesh.device
            local_batch = _rank_batch(batch, mesh, microbatches)
            with timing.span("train.forward_backward", device=dev), activation_sharding(mesh), (
                    zero.layerwise(stored, pstore) if layerwise else contextlib.nullcontext()):
                loss, grads = _loss_and_grads(loss_fn, stored, local_batch, microbatches)
            loss = dp_mean(loss.float(), None)
            if layerwise:  # ZeRO-3: a split leaf's summed over data in its gather's backward
                grads = tree_map2(lambda g, sh: dp_mean(g, None, zero.data_dim(sh, g.ndim) is None),
                                  grads, pstore)
            elif grad_shardings is None:
                grads = tree_map(lambda g: dp_mean(g, None), grads)
            else:  # ZeRO-2
                grads = tree_map2(dp_mean, grads, grad_shardings)
            whole_grads = grad_shardings is None and not layerwise
            grads_m = tree_map2(lambda g, sh: moments_view(g, sh, whole_grads), grads, mspecs)
            params_m = tree_map2(lambda p, sh: moments_view(p, sh, not layerwise), stored, mspecs)
            with timing.span("train.clip", device=dev):
                gnorm = _global_norm(grads_m, mspecs, mesh)
                scale = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
                for g in tree_leaves(grads_m):
                    g.mul_(scale)
            with timing.span("train.optimizer", device=dev):
                lr = lr_fn(opt_state.step)
                updates, opt_state = optimizer.update(grads_m, opt_state, params_m, lr)
                optimizer.apply(params_m, updates)
                if not layerwise:  # every rank takes the other ranks' updated slices
                    for p, pm, sh in zip(tree_leaves(stored), tree_leaves(params_m),
                                         tree_leaves(mspecs)):
                        dim = zero.data_dim(sh, p.ndim)
                        if dim is not None:
                            p.copy_(collectives.all_gather(pm, mesh, "data", dim))
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(stored, opt_state), metrics

    return step


@torch.no_grad()
def _global_norm(grads_m, mspecs, mesh) -> torch.Tensor:
    """The global norm of grads held in the moments' layout: each leaf's
    squares summed over the ``data`` and ``model`` ranks its layout splits
    it over, a whole leaf's counted once."""
    groups: dict = {}
    for g, sh in zip(tree_leaves(grads_m), tree_leaves(mspecs)):
        split = {a for axes in sh.dim_axes(g.ndim) for a in axes}
        key = tuple(a for a in ("data", "model") if a in split and mesh.shape.get(a, 1) > 1)
        groups.setdefault(key, []).append(torch.sum(torch.square(g.float())))
    total = torch.zeros((), dtype=torch.float32, device=tree_leaves(grads_m)[0].device)
    for axes in sorted(groups):
        part = torch.sum(torch.stack(groups[axes]))
        for a in axes:
            part = collectives.all_reduce(part, mesh, a)
        total = total + part
    return torch.sqrt(total)


def init_state(model_init: Callable, optimizer: AdamW, gen: torch.Generator) -> TrainState:
    params = model_init(gen)
    return TrainState(params=params, opt=optimizer.init(params))


def state_shapes(model_init: Callable, optimizer: AdamW) -> TrainState:
    """The TrainState's shapes and dtypes as ``meta`` tensors, with no
    storage allocated (the reference's ``jax.eval_shape``).  ``model_init``
    takes a CPU generator (a model built with ``device="cpu"``); it runs
    under fake tensors, so a full-width model costs nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        state = init_state(model_init, optimizer, torch.Generator())
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
    return TrainState(params=tree_map(meta, state.params),
                      opt=AdamWState(step=meta(state.opt.step), mu=tree_map(meta, state.opt.mu),
                                     nu=tree_map(meta, state.opt.nu)))
