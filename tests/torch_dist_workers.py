"""Rank functions for the distribution layer's tests (CPU and card).

``repro_torch.dist.run_ranks`` spawns one process per rank and imports each
function here by name, so they live in a module that imports no JAX (a
rank then starts in about a second).  Each takes its rank first and returns
numpy arrays or plain Python values.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.dist import (P, NamedSharding, gather_tree, gpipe_apply, psum_compressed,
                              shard_tree, zero_layouts)
from repro_torch.ft import ElasticController
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.common import tree_map
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamW, AdamWState
from repro_torch.optim.schedule import constant
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.train.step import TrainState, make_train_step


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def world(rank):
    import torch.distributed as tdist

    return rank, tdist.get_world_size(), tdist.get_backend()


def fail_on_one(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    import torch.distributed as tdist

    tdist.barrier()  # rank 0 waits for rank 1, which never comes
    return rank


def hang_on_one(rank):
    import time

    if rank == 1:
        time.sleep(600)
    return rank


# ---------------------------------------------------------------------------
# compression and GPipe over a 2-rank `pod` axis
# ---------------------------------------------------------------------------
def compress(rank, x):
    """Rank r holds (r + 1) * x; the compressed and exact sums over pod."""
    mesh = Mesh((2,), ("pod",)).bind()
    v = torch.from_numpy(x) * (rank + 1)
    return {"int8": psum_compressed(v, "pod", "int8", mesh=mesh).numpy(),
            "none": psum_compressed(v, "pod", "none", mesh=mesh).numpy()}


def gpipe(rank, w, x):
    """gpipe_apply of tanh(h @ w[s]) stages, its output and the gradient of
    sum(y**2) over the whole stage stack; and the stage-dim error."""
    mesh = Mesh((2,), ("pod",)).bind()
    spec = {"w": NamedSharding(mesh, P("pod"))}
    local = shard_tree({"w": torch.from_numpy(w)}, spec)
    local["w"].requires_grad_(True)
    y = gpipe_apply(lambda p, h: torch.tanh(h @ p["w"]), local, torch.from_numpy(x), mesh, "pod")
    (y ** 2).sum().backward()
    grad = gather_tree({"w": local["w"].grad}, spec)["w"]
    try:
        gpipe_apply(lambda p, h: h, {"w": torch.from_numpy(w)}, torch.from_numpy(x), mesh, "pod")
        error = None
    except ValueError as e:
        error = str(e)
    return {"y": y.detach().numpy(), "grad": grad.numpy(), "error": error}


# ---------------------------------------------------------------------------
# ZeRO data parallelism on (data=2, model=1)
# ---------------------------------------------------------------------------
def zero_steps(rank, runs, lr):
    """For each (name, zero_stage, params, batches) of ``runs``: the
    data-parallel step from the global params over the batches; the metrics
    of each step and the gathered params and first moments after them."""
    mesh = Mesh((2, 1), ("data", "model")).bind()
    out = []
    for name, stage, np_params, batches in runs:
        cfg = get_config(name).reduced().replace(zero_stage=stage)
        model = build_model(cfg, device="cpu")
        params = params_from_jax(np_params, cfg, device="cpu")
        lay = zero_layouts(params, cfg, mesh)
        opt = AdamW()
        state = TrainState(shard_tree(params, lay.params),
                           opt.init(shard_tree(params, lay.moments)))
        step = make_train_step(model.loss_fn, opt, constant(lr), grad_shardings=lay.grads,
                               state_shardings=TrainState(lay.params,
                                                          AdamWState(None, lay.moments,
                                                                     lay.moments)))
        metrics = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        local_shapes = [tuple(t.shape) for t in
                        (state.params["embed"], state.opt.mu["embed"])]
        out.append({"metrics": metrics, "local_shapes": local_shapes,
                    "params": _np(gather_tree(state.params, lay.params)),
                    "mu": _np(gather_tree(state.opt.mu, lay.moments))})
    return out


# ---------------------------------------------------------------------------
# tensor-parallel serving on a 1-D model axis
# ---------------------------------------------------------------------------
def tp_engines(rank, tp, cases, prompts, max_new):
    """For each (name, np_params, page_size) of ``cases``: the token streams
    of an engine on a ``model`` mesh of ``tp`` ranks, and the prefill's last
    logits (gathered) of ``prompts[0]`` run under the mesh."""
    from repro_torch.dist import activation_sharding, param_specs

    mesh = Mesh((tp,), ("model",)).bind()
    out = []
    for name, np_params, page_size in cases:
        cfg = get_config(name).reduced()
        model = build_model(cfg, device="cpu")
        params = params_from_jax(np_params, cfg, device="cpu")
        engine = ServeEngine(model, params, EngineConfig(
            n_slots=2, max_len=32, prefill_chunk=4, page_size=page_size, mesh=mesh))
        sessions = [engine.submit(p, max_new) for p in prompts]
        engine.run()
        local = shard_tree(params, param_specs(params, cfg, mesh))
        with activation_sharding(mesh):
            logits, cache = model.prefill(local, {"tokens": torch.tensor([prompts[0]])})
        out.append({"tokens": [s.out for s in sessions], "logits": logits.numpy(),
                    "cache_heads": int(cache["k"].shape[3]),
                    "wq_heads": int(engine.params["layers"]["attn"]["wq"].shape[2]),
                    "embed_rows": int(engine.params["embed"].shape[0])})
    return out


def tp_refuses_autograd(rank, np_params):
    """A model axis > 1 under autograd must raise before any collective."""
    from repro_torch.dist import activation_sharding, param_specs
    from repro_torch.train.step import value_and_grad

    mesh = Mesh((2,), ("model",)).bind()
    cfg = get_config("gemma-2b").reduced()
    model = build_model(cfg, device="cpu")
    params = params_from_jax(np_params, cfg, device="cpu")
    local = shard_tree(params, param_specs(params, cfg, mesh))
    batch = {"tokens": torch.ones((2, 8), dtype=torch.int32),
             "targets": torch.ones((2, 8), dtype=torch.int32)}
    with activation_sharding(mesh):
        try:
            value_and_grad(model.loss_fn, local, batch)
        except NotImplementedError as e:
            return str(e)
    return None


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------
def save_then_reshard(rank, directory, tree, ref_directory):
    """Save ``tree`` sharded on (data=2, model=1) from its shards; restore it
    on (data=1, model=2) and restore the reference's checkpoint in
    ``ref_directory`` on (data=2, model=1): each rank's shards."""
    src = Mesh((2, 1), ("data", "model")).bind()
    save_sh = {"w": NamedSharding(src, P("data", None)), "b": NamedSharding(src, P())}
    mgr = CheckpointManager(directory)
    mgr.save(3, shard_tree({k: torch.from_numpy(v) for k, v in tree.items()}, save_sh),
             shardings=save_sh)
    dst = Mesh((1, 2), ("data", "model")).bind()
    like = {k: torch.empty(v.shape, dtype=torch.float32, device="meta") for k, v in tree.items()}
    new_sh = {"w": NamedSharding(dst, P(None, "model")), "b": NamedSharding(dst, P("model"))}
    step, moved = mgr.restore(like, shardings=new_sh)
    ref_step, ref = CheckpointManager(ref_directory).restore(like, shardings=save_sh)
    return {"step": step, "moved": _np(moved), "ref_step": ref_step, "ref": _np(ref)}


def elastic_resume(rank, directory, shape):
    """Resume the checkpoint in ``directory`` on one rank through
    ``ElasticController``: the planned mesh, the step, the tree and the
    data pipeline's seek."""

    class Pipe:
        at = None

        def seek(self, step):
            self.at = step

    ctl = ElasticController(model_parallel=1, ckpt=CheckpointManager(directory),
                            devices_total=2)
    mesh = ctl.plan_mesh(1).bind()
    like = {k: torch.empty(s, dtype=torch.float32, device="meta") for k, s in shape.items()}
    sh = {"w": NamedSharding(mesh, P("data", "model")), "b": NamedSharding(mesh, P())}
    pipe = Pipe()
    step, tree = ctl.resume(like, sh, pipe)
    return {"mesh": dict(mesh.shape), "step": step, "seek": pipe.at, "tree": _np(tree)}


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda.py): ranks sharing the GPU over gloo
# ---------------------------------------------------------------------------
def card_collectives(rank):
    """The layer's collectives on CUDA tensors over gloo (staged through the
    host): each result against the same sum, concatenation or hop taken
    locally from every rank's input."""
    from repro_torch.dist import collectives, rank_device

    mesh = Mesh((2,), ("pod",)).bind(rank_device("cuda", rank))
    dev = mesh.device

    def inp(r, dtype):
        g = torch.Generator(device=dev).manual_seed(r)
        return torch.randn((64, 48), generator=g, device=dev).to(dtype)

    ok = {}
    for dtype in (torch.float32, torch.bfloat16):
        mine, both = inp(rank, dtype), [inp(r, dtype) for r in range(2)]
        summed = (both[0].float() + both[1].float()).to(dtype)
        ok[f"all_reduce_{dtype}"] = torch.equal(collectives.all_reduce(mine, mesh, "pod"),
                                                summed)
        ok[f"all_gather_{dtype}"] = torch.equal(collectives.all_gather(mine, mesh, "pod", 1),
                                                torch.cat(both, 1))
        ok[f"reduce_scatter_{dtype}"] = torch.equal(
            collectives.reduce_scatter(mine, mesh, "pod", 0), summed[32 * rank:32 * rank + 32])
        ok[f"shift_{dtype}"] = torch.equal(collectives.shift(mine, mesh, "pod", 1),
                                           both[1 - rank])
        ok[f"on_device_{dtype}"] = collectives.all_reduce(mine, mesh, "pod").device == dev
    return ok


def card_nccl(rank):
    """A world of one rank over NCCL: the collectives on the card."""
    import torch.distributed as tdist

    from repro_torch.dist import collectives, rank_device

    mesh = Mesh((1,), ("data",)).bind(rank_device("cuda", rank))
    x = torch.randn((8, 6), device=mesh.device).bfloat16()
    return {"backend": tdist.get_backend(),
            "all_reduce": torch.equal(collectives.all_reduce(x, mesh, "data"), x),
            "all_gather": torch.equal(collectives.all_gather(x, mesh, "data", 0), x),
            "reduce_scatter": torch.equal(collectives.reduce_scatter(x.float(), mesh, "data", 1),
                                          x.float())}


def card_tp_prefill(rank, cfg, tokens):
    """gemma-2b's width at the given depth on a 2-rank ``model`` mesh on the
    card: the flash launches of one prefill on this rank's heads and its
    gathered last logits."""
    from repro_torch.dist import activation_sharding, param_specs, rank_device
    from repro_torch.kernels import _util

    mesh = Mesh((2,), ("model",)).bind(rank_device("cuda", rank))
    model = build_model(cfg, device=mesh.device)
    params = model.init(torch.Generator(device=mesh.device).manual_seed(0))
    local = shard_tree(params, param_specs(params, cfg, mesh))
    del params
    with torch.inference_mode(), activation_sharding(mesh):
        _util.reset_launch_counts()
        last, _ = model.prefill(local, {"tokens": torch.as_tensor(tokens, device=mesh.device)})
        torch.cuda.synchronize()
        launches = _util.launch_counts()
    return {"launches": launches, "last": last.float().cpu(),
            "wq_heads": int(local["layers"]["attn"]["wq"].shape[2])}
