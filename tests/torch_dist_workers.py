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
from repro_torch.dist.sharding import tree_leaves, tree_map2, tree_map_with_path
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
    return tree_map_with_path(lambda _, t: t.detach().numpy().copy(), tree)


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


def zero3_extra_leaf(rank, cases, lr):
    """For each (extra leaf's shape, whether the loss takes it through
    ``dist.zero.whole``) of ``cases``: gemma-2b ``reduced()`` with one extra
    param, whose loss adds a batch-dependent term in it, one stage-3 step on
    (data=2, model=1) against the one-process step on the global batch on
    this rank.  Returns, per case, both metrics and the gathered extra leaf
    and embedding, or the step's error."""
    from repro_torch.dist import zero

    mesh = Mesh((2, 1), ("data", "model")).bind()
    cfg = get_config("gemma-2b").reduced().replace(zero_stage=3)
    model = build_model(cfg, device="cpu")
    batch = {"tokens": torch.arange(64, dtype=torch.int32).reshape(4, 16) % cfg.vocab_size}
    batch["targets"] = (batch["tokens"] + 1) % cfg.vocab_size
    out = []
    for shape, through_whole in cases:
        def loss_fn(params, b):
            extra = zero.whole(params["extra"]) if through_whole else params["extra"]
            rest = {k: v for k, v in params.items() if k != "extra"}
            return model.loss_fn(rest, b) + (extra ** 2).sum() * b["tokens"].float().mean() / 64

        def fresh():
            params = model.init(torch.Generator().manual_seed(0))
            params["extra"] = torch.linspace(-1, 1, int(np.prod(shape))).reshape(shape)
            return params

        opt = AdamW()
        one = make_train_step(loss_fn, opt, constant(lr), microbatches=cfg.train_microbatches)
        params = fresh()
        one_state, one_m = one(TrainState(params, opt.init(params)), batch)
        params = fresh()
        lay = zero_layouts(params, cfg, mesh)
        state = TrainState(shard_tree(params, lay.params), opt.init(shard_tree(params,
                                                                              lay.moments)))
        step = make_train_step(loss_fn, opt, constant(lr), microbatches=cfg.train_microbatches,
                               grad_shardings=lay.grads,
                               state_shardings=TrainState(lay.params, AdamWState(
                                   None, lay.moments, lay.moments)))
        try:
            state, m = step(state, batch)
        except RuntimeError as e:
            out.append({"error": str(e)})
            continue
        got = gather_tree(state.params, lay.params)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "one_metrics": {k: float(v) for k, v in one_m.items()},
                    "data_dim": zero.data_dim(lay.params["extra"], len(shape)),
                    "params": _np({k: got[k] for k in ("extra", "embed")}),
                    "one_params": _np({k: one_state.params[k] for k in ("extra", "embed")})})
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


def tp_value_and_grad_families(rank, names):
    """For each name: a ``value_and_grad`` of its ``reduced()`` model on a
    2-rank ``model`` mesh, its params placed by ``param_specs``.  Returns
    each name's ``NotImplementedError`` message (None: it ran) and the
    collectives it issued."""
    from repro_torch.dist import activation_sharding, collectives, param_specs
    from repro_torch.train.step import value_and_grad

    mesh = Mesh((2,), ("model",)).bind()
    issued = []
    real = {k: getattr(collectives, k) for k in ("all_reduce", "all_gather", "broadcast",
                                                  "reduce", "reduce_scatter", "shift")}
    for k, fn in real.items():
        setattr(collectives, k, lambda *a, _k=k, _fn=fn, **kw: issued.append(_k) or _fn(*a, **kw))
    out = {}
    try:
        for name in names:
            cfg = get_config(name).reduced()
            model = build_model(cfg, device="cpu")
            params = model.init(torch.Generator().manual_seed(0))
            params = shard_tree(params, param_specs(params, cfg, mesh))
            batch = {"tokens": torch.ones((2, 8), dtype=torch.int32),
                     "targets": torch.ones((2, 8), dtype=torch.int32)}
            issued.clear()
            with activation_sharding(mesh):
                try:
                    value_and_grad(model.loss_fn, params, batch)
                    out[name] = (None, list(issued))
                except NotImplementedError as e:
                    out[name] = (str(e), list(issued))
    finally:
        for k, fn in real.items():
            setattr(collectives, k, fn)
    return out


# ---------------------------------------------------------------------------
# training on a (data, model) mesh
# ---------------------------------------------------------------------------
def _local_slices(specs, shapes):
    """Each leaf's slice on this rank, as (start, stop) pairs."""
    from repro_torch.dist.sharding import local_index

    return tree_map2(lambda sh, t: [(s.start, s.stop) for s in local_index(sh, t.shape)],
                     specs, shapes)


def tp_grads(rank, cases, batch):
    """For each (name, np_params, config overrides) of ``cases``: a
    ``value_and_grad`` of the ``reduced()`` model on (data=1, model=2) over
    the whole ``batch``, from the global params placed by ``param_specs``;
    this rank's loss, its local grads and each leaf's slice."""
    from repro_torch.dist import activation_sharding, param_specs
    from repro_torch.train.step import value_and_grad

    mesh = Mesh((1, 2), ("data", "model")).bind()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for name, np_params, kw in cases:
        cfg = get_config(name).reduced().replace(**kw)
        model = build_model(cfg, device="cpu")
        params = params_from_jax(np_params, cfg, device="cpu")
        specs = param_specs(params, cfg, mesh)
        local = shard_tree(params, specs)
        with activation_sharding(mesh):
            if cfg.remat:  # the backward on another thread, as the card runs it
                loss, grads = _backward_elsewhere(model.loss_fn, local, tbatch)
            else:
                loss, grads = value_and_grad(model.loss_fn, local, tbatch)
        out.append({"loss": float(loss), "grads": _np(grads),
                    "slices": _local_slices(specs, params)})
    return out


def _backward_elsewhere(loss_fn, params, batch):
    """``value_and_grad`` with the forward on this thread and the backward
    (the checkpointed blocks' recompute with it) on a fresh one, where no
    mesh is current: on the card the autograd engine runs a device's
    backward on its own worker thread."""
    import threading

    from repro_torch.models.common import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    box = {}
    worker = threading.Thread(target=lambda: box.update(g=torch.autograd.grad(loss, leaves)))
    worker.start()
    worker.join()
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), _unflatten(params, list(box["g"]))


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class _GatherLog:
    """``dist.collectives`` as ``dist.zero`` calls it, with the shape of
    every tensor its gathers return recorded."""

    def __init__(self, collectives):
        self.real, self.shapes = collectives, []

    def __getattr__(self, name):
        fn = getattr(self.real, name)
        if name not in ("broadcast", "all_gather"):
            return fn

        def logged(*args, **kw):
            y = fn(*args, **kw)
            self.shapes.append(tuple(y.shape))
            return y

        return logged


def tp_train_steps(rank, runs, lr, ckpt_dir):
    """For each (name, zero_stage, np_params, batch, config overrides) of
    ``runs``: one step on (data=2, model=2) from the global params at the
    config's microbatches; the metrics, the gathered params and first
    moments, and at stage 3 the shapes ``dist.zero``'s gathers returned.
    With ``ckpt_dir``, the last run's state is saved there from its shards."""
    from repro_torch.dist import param_specs, zero

    mesh = Mesh((2, 2), ("data", "model")).bind()
    out = []
    for name, stage, np_params, batch, kw in runs:
        cfg = get_config(name).reduced().replace(zero_stage=stage, **kw)
        model = build_model(cfg, device="cpu")
        params = params_from_jax(np_params, cfg, device="cpu")
        lay = zero_layouts(params, cfg, mesh)
        opt = AdamW()
        state = TrainState(shard_tree(params, lay.params),
                           opt.init(shard_tree(params, lay.moments)))
        shardings = TrainState(lay.params, AdamWState(NamedSharding(mesh, P()), lay.moments,
                                                      lay.moments))
        step = make_train_step(model.loss_fn, opt, constant(lr),
                               microbatches=cfg.train_microbatches, grad_shardings=lay.grads,
                               state_shardings=shardings)
        log, real = _GatherLog(zero.collectives), zero.collectives
        zero.collectives = log
        try:
            state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        finally:
            zero.collectives = real
        local = shard_tree(params, param_specs(params, cfg, mesh))
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "gathered": log.shapes,
                    "local_shapes": tree_map(lambda t: tuple(t.shape), local),
                    "stored_shapes": tree_map(lambda t: tuple(t.shape), state.params),
                    "params": _np(gather_tree(state.params, lay.params)),
                    "mu": _np(gather_tree(state.opt.mu, lay.moments))})
    if ckpt_dir is not None:
        CheckpointManager(ckpt_dir).save(1, state, shardings=shardings)
        out[-1]["state"] = _np(TrainState(gather_tree(state.params, lay.params), AdamWState(
            state.opt.step, gather_tree(state.opt.mu, lay.moments),
            gather_tree(state.opt.nu, lay.moments))))
    return out


def restore_on_one(rank, directory, like):
    """Restore the checkpoint in ``directory`` on one rank through
    ``ckpt.reshard.load_resharded``, every leaf replicated on (data=1,
    model=1): the step and the tree."""
    from repro_torch.ckpt.reshard import load_resharded

    mesh = Mesh((1, 1), ("data", "model")).bind()
    like = tree_map(lambda s: torch.empty(s, dtype=torch.float32, device="meta"), like)
    step_like = torch.empty((), dtype=torch.int32, device="meta")
    like = TrainState(like["params"], AdamWState(step_like, like["mu"], like["nu"]))
    rep = NamedSharding(mesh, P())
    step, tree = load_resharded(CheckpointManager(directory), like,
                                tree_map2(lambda *_: rep, like, like))
    return step, _np(tree)


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


def card_2d_step(rank, cfg, params, batch, lr):
    """One step of ``cfg`` on (data=2, model=2), this rank on the card, from
    the global ``params`` (CPU tensors) over the global ``batch``: the
    metrics, the kernel launches and the gathered params (on the host)."""
    from repro_torch.dist import rank_device
    from repro_torch.kernels import _util

    mesh = Mesh((2, 2), ("data", "model")).bind(rank_device("cuda", rank))
    model = build_model(cfg, device=mesh.device)
    lay = zero_layouts(params, cfg, mesh)
    opt = AdamW()
    state = TrainState(shard_tree(params, lay.params), opt.init(shard_tree(params, lay.moments)))
    step = make_train_step(model.loss_fn, opt, constant(lr), microbatches=cfg.train_microbatches,
                           grad_shardings=lay.grads,
                           state_shardings=TrainState(lay.params, AdamWState(None, lay.moments,
                                                                             lay.moments)))
    _util.reset_launch_counts()
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    torch.cuda.synchronize()
    return {"metrics": {k: float(m[k]) for k in ("loss", "grad_norm")},
            "launches": _util.launch_counts(),
            "device": state.params["embed"].device.type,
            "params": tree_map(lambda t: t.cpu(), gather_tree(state.params, lay.params))}


# ---------------------------------------------------------------------------
# the hybrid, xLSTM, encoder-decoder and VLM families on a `model` mesh
# ---------------------------------------------------------------------------
def family_forward(params, batch, cfg):
    """The family's full-sequence logits (B, S, V) of ``batch``."""
    from repro_torch.models import encdec, mamba, transformer, xlstm

    if cfg.family == "hybrid":
        return mamba.zamba_forward(params, batch["tokens"], cfg)
    if cfg.family == "ssm":
        return xlstm.xlstm_forward(params, batch["tokens"], cfg)
    if cfg.family == "encdec":
        enc_out = encdec.encode(params, batch["frontend"], cfg)
        return encdec.decode_train(params, batch["tokens"], enc_out, cfg)
    return transformer.lm_forward(params, batch["tokens"], cfg, batch.get("frontend"))[0]


def prompt_len(cfg, batch) -> int:
    """The positions a prefill of ``batch`` fills: the tokens, and a VLM's
    frontend before them."""
    extra = batch["frontend"].shape[1] if cfg.family == "vlm" else 0
    return batch["tokens"].shape[1] + extra


def tp_family(rank, tp, cases, steps):
    """For each (name, np_params, config overrides, batch) of ``cases``, on
    a ``model`` mesh of ``tp`` ranks from the global params placed by
    ``param_specs``: the forward's logits, the loss with this rank's grads
    and each leaf's slice, the prefill's last logits and its cache gathered
    by ``cache_shardings``, and ``steps`` greedy ``decode_step``s' logits,
    tokens and final cache, gathered the same way."""
    from repro_torch.dist import activation_sharding, cache_shardings, param_specs
    from repro_torch.train.step import value_and_grad

    mesh = Mesh((tp,), ("model",)).bind()
    out = []
    for name, np_params, kw, batch in cases:
        cfg = get_config(name).reduced().replace(**kw)
        model = build_model(cfg, device="cpu")
        params = params_from_jax(np_params, cfg, device="cpu")
        specs = param_specs(params, cfg, mesh)
        local = shard_tree(params, specs)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        feed = {k: v for k, v in tb.items() if k != "targets"}
        b, s = tb["tokens"].shape[0], prompt_len(cfg, batch)
        cspecs = cache_shardings(model.cache_specs(b, s + steps), cfg, mesh)
        res = {}
        with activation_sharding(mesh):
            with torch.no_grad():
                res["logits"] = family_forward(local, tb, cfg).numpy()
            loss, grads = value_and_grad(model.loss_fn, local, tb)
            res.update(loss=float(loss), grads=_np(grads), slices=_local_slices(specs, params))
            with torch.no_grad():
                last, cache = model.prefill(local, feed, s + steps)
                res["cache_local"] = tree_map(lambda t: tuple(t.shape), cache)
                res["prefill_last"] = last.numpy()
                res["prefill_cache"] = _np(gather_tree(cache, cspecs))
                tok, rows, toks = last.argmax(-1), [], []
                for i in range(steps):
                    pos = torch.full((b,), s + i, dtype=torch.int32)
                    logits, cache = model.decode_step(local, cache, tok.to(torch.int32), pos)
                    tok = logits.argmax(-1)
                    rows.append(logits.numpy())
                    toks.append(tok.numpy())
                res.update(step_logits=np.stack(rows), tokens=np.stack(toks),
                           final_cache=_np(gather_tree(cache, cspecs)))
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# sequence parallelism on a `model` mesh
# ---------------------------------------------------------------------------
def rs_inputs(rank, n):
    """Rank ``rank``'s seeded bf16 input to the reduce-scatter check."""
    g = torch.Generator().manual_seed(100 + rank)
    return torch.randn((2 * n, 3 * n, 5), generator=g).bfloat16()


def seq_parallel(rank, tp, cases):
    """On a ``model`` mesh of ``tp`` ranks, for each (name, np_params, batch)
    of ``cases`` (a ``reduced()`` transformer from global params placed by
    ``param_specs``): the stream's shape at each block's input in
    ``lm_forward`` and in ``lm_prefill``, the forward's logits, the
    prefill's last logits, this rank's cache and the KV heads it holds, and
    under remat's two policies (the backward on another thread) the loss
    and this rank's grads, with each leaf's slice.  Then a bf16
    ``reduce_scatter`` on dims 0 and 1 of ``rs_inputs`` with its recorded
    calls, and the fp32 all-reduce of the same inputs."""
    from repro_torch.dist import activation_sharding, collectives, param_specs
    from repro_torch.dist import tensor_parallel as tpar
    from repro_torch.models import transformer

    torch.set_num_threads(1)  # tiny shapes: the ranks share the host's cores
    mesh = Mesh((tp,), ("model",)).bind()
    real = {k: getattr(transformer, k) for k in ("_block_apply", "_block_prefill")}
    seen = []

    def spy(fn):
        def run(cfg, p, x, positions):
            seen.append(tuple(x.shape))
            return fn(cfg, p, x, positions)
        return run

    out = []
    for name, np_params, batch in cases:
        cfg = get_config(name).reduced()
        params = params_from_jax(np_params, cfg, device="cpu")
        specs = param_specs(params, cfg, mesh)
        local = shard_tree(params, specs)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        res = {"slices": _local_slices(specs, params)}
        with activation_sharding(mesh):
            for k, fn in real.items():
                setattr(transformer, k, spy(fn))
            try:
                with torch.no_grad():
                    logits, _ = transformer.lm_forward(local, tb["tokens"], cfg, tb.get("frontend"))
                    res["forward_inputs"], seen[:] = list(seen), []
                    last, cache = build_model(cfg, device="cpu").prefill(
                        local, {k: v for k, v in tb.items() if k != "targets"})
                    res["prefill_inputs"], seen[:] = list(seen), []
            finally:
                for k, fn in real.items():
                    setattr(transformer, k, fn)
            res.update(logits=logits.numpy(), prefill_last=last.numpy(), cache=_np(cache),
                       kv_heads=tpar.local_range(cfg.n_kv_heads))
            for policy in ("full", "dots"):
                rcfg = cfg.replace(remat=True, remat_policy=policy)
                loss, grads = _backward_elsewhere(build_model(rcfg, device="cpu").loss_fn, local,
                                                  tb)
                res[policy] = {"loss": float(loss), "grads": _np(grads)}
        out.append(res)
    x = rs_inputs(rank, tp)
    with collectives.recording(dry=False) as rec:
        rs = [collectives.reduce_scatter(x, mesh, "model", dim) for dim in (0, 1)]
    summed = collectives.all_reduce(x.float(), mesh, "model")
    return {"cases": out, "rs": [t.float().numpy() for t in rs],
            "rs_dtypes": [str(t.dtype) for t in rs], "rs_calls": [tuple(c) for c in rec.calls],
            "all_reduce_fp32": summed.numpy()}


# ---------------------------------------------------------------------------
# a rank group kept between calls
# ---------------------------------------------------------------------------
def remember(rank, x):
    """Keep ``x`` times (rank + 1) in this rank's state; the world's sum."""
    import torch.distributed as tdist

    from repro_torch.dist import rank_state

    rank_state()["x"] = torch.tensor(float(x * (rank + 1)))
    total = rank_state()["x"].clone()
    tdist.all_reduce(total)
    return float(total)


def recall(rank):
    from repro_torch.dist import rank_state

    return float(rank_state()["x"]), len(rank_state())


def fail_on_rank(rank, bad):
    if rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    return rank


def fail_engine_step(rank, bad, after, how):
    """Make rank ``bad``'s serving engine (a tensor-parallel replica's)
    fail at its ``after``-th step from now: raise (``how="raise"``), or end
    its process (``how="exit"``)."""
    import os

    from repro_torch.dist import rank_state

    if rank != bad:
        return rank
    engine = rank_state()["engine"]
    step, left = engine.step, [after]

    def failing():
        left[0] -= 1
        if left[0] <= 0:
            if how == "exit":
                os._exit(1)
            raise RuntimeError(f"rank {bad} fails on purpose")
        return step()

    engine.step = failing
    return rank


def dp_engines(rank, shape, axes, cases, prompts, max_new):
    """For each (name, np_params, page_size, n_slots) of ``cases``: the
    token streams of an engine on the mesh ``shape`` over ``axes`` (any of
    pod, data, model), and its local param and cache leaf shapes (in
    ``tree_leaves`` order)."""
    mesh = Mesh(shape, axes).bind()
    out = []
    for name, np_params, page_size, n_slots in cases:
        cfg = get_config(name).reduced()
        model = build_model(cfg, device="cpu")
        params = params_from_jax(np_params, cfg, device="cpu")
        engine = ServeEngine(model, params, EngineConfig(
            n_slots=n_slots, max_len=32, prefill_chunk=4, page_size=page_size, mesh=mesh))
        sessions = [engine.submit(p, max_new) for p in prompts]
        engine.run()
        out.append({"tokens": [s.out for s in sessions],
                    "params": [tuple(t.shape) for t in tree_leaves(engine.params)],
                    "cache": [tuple(t.shape) for t in tree_leaves(engine.cache)]})
    return out


def cell_collectives(rank, cases):
    """For each (arch, config overrides, shape, seq_len, global_batch, mesh
    shape, axes) of ``cases``: the dry-run cell's step run for real on this
    rank's shards of seeded global arguments (floats N(0, 0.02), integers
    0), its collectives recorded as they run (``{op: {calls, bytes}}``);
    for a decode cell also the largest error of its outputs, relative to
    each output's largest value, against the whole step's, sliced as the
    cell's output layouts say."""
    import dataclasses

    from repro_torch.configs import get_shape
    from repro_torch.dist import activation_sharding, collectives
    from repro_torch.dist.sharding import local_index
    from repro_torch.kernels.api import kernel_policy
    from repro_torch.launch.cell import build_cell

    gen = torch.Generator().manual_seed(0)

    def real(_, t):
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen) * 0.02).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)

    out = []
    for arch, kw, shape, seq, batch, mesh_shape, axes in cases:
        cell = build_cell(get_config(arch).reduced().replace(**kw),
                          dataclasses.replace(get_shape(shape), seq_len=seq, global_batch=batch),
                          Mesh(mesh_shape, axes))
        cell.mesh.bind()
        whole = tree_map_with_path(real, cell.args)
        args = shard_tree(whole, cell.in_shardings)
        with collectives.recording(dry=False) as rec, activation_sharding(cell.mesh), \
                kernel_policy(backend="torch"):
            got = cell.fn(*args)
        res = {"collectives": rec.by_op()}
        if shape.startswith("decode"):  # against the whole step, sliced as the layouts say
            with kernel_policy(backend="torch"):
                want = build_model(cell.cfg, device="cpu").decode_step(*whole)
            res["max_rel_err"] = max(
                float((g.float() - w[local_index(sh, w.shape)].float()).abs().max()
                      / w.float().abs().max().clamp_min(1e-30))
                for g, w, sh in zip(tree_leaves(got), tree_leaves(want),
                                    tree_leaves(cell.out_shardings)))
        out.append(res)
    return out
