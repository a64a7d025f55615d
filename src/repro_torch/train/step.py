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
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

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


def make_train_step(
    loss_fn: Callable,  # (params, batch) -> scalar
    optimizer: AdamW,
    lr_fn: Callable,  # step -> lr
    microbatches: int = 1,
    clip_norm: float = 1.0,
    grad_shardings=None,
):
    """Returns step(state, batch) -> (state, metrics)."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings: ZeRO-2 grad layouts wait for the port's distribution layer "
            "(ROADMAP.md §1 item 11); pass grad_shardings=None"
        )

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params, opt_state = state
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            def split(x, i):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch of {b} does not split into {microbatches} "
                                     "microbatches")
                return x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))[i]

            loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
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

        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(opt_state.step)
        updates, opt_state = optimizer.update(grads, opt_state, params, lr)
        params = optimizer.apply(params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params, opt_state), metrics

    return step


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
