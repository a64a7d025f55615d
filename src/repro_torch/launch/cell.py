"""Dry-run cell construction: (arch x shape x mesh) -> one rank's step
function with its input/output shardings.

Port of ``repro.launch.cell``.  The reference builds a jitted step that XLA
lowers and compiles for the whole mesh.  The port is SPMD: a :class:`Cell`
holds the step one rank runs on its shards (the data-parallel train step of
``train/step.py``, the model's ``prefill``/``decode_step`` under
``dist.activation_sharding``) and the global shapes and layouts of its
arguments.  :meth:`Cell.lower` is the dry run: the mesh placed at one rank on
the ``meta`` device (``Mesh.place``), that rank's shards cut from the global
``meta`` arguments (``dist.shard_tree``), and the step run once with its
collectives recorded, not sent (``dist.collectives.recording``), its FLOPs
and bytes counted (``perfmodel.extract_costs``).  No world, no process group
and no storage.  What it counts is what the port runs on that rank.

The analytic parts (parameter counts, ``_local_bytes``, ``analytic_memory``)
are the reference's formulas on the same shapes and layouts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist import collectives, zero
from repro_torch.dist.sharding import (
    NamedSharding,
    P,
    activation_sharding,
    batch_shardings,
    cache_shardings,
    logits_sharding,
    param_specs,
    shard_tree,
    tree_leaves,
    tree_map_with_path,
)
from repro_torch.dist.zero import zero1_state_specs, zero_layouts
from repro_torch.kernels.api import kernel_policy
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.api import input_specs
from repro_torch.models.common import tree_map
from repro_torch.optim import AdamW, AdamWState
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.perfmodel.costs import CompiledCosts, extract_costs
from repro_torch.train.step import TrainState, make_train_step, state_shapes


class Lowered(NamedTuple):
    """One rank's dry run of a cell: the collectives it called
    (``dist.collectives.CollectiveCall``, in order), its counted costs, and
    the seconds to cut its shards and to run its step."""

    calls: list
    costs: CompiledCosts
    build_s: float
    run_s: float


@dataclass
class Cell:
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Mesh
    fn: Callable
    args: tuple
    in_shardings: Any
    out_shardings: Any
    donate: tuple
    n_params: float
    n_params_active: float

    @property
    def name(self) -> str:
        pods = self.mesh.shape.get("pod", 1)
        return f"{self.cfg.name}__{self.shape.name}__{'multi' if pods > 1 else 'single'}"

    def local_args(self, rank: int = 0) -> tuple:
        """``rank``'s shards of the global arguments, as ``meta`` tensors
        (the mesh placed at ``rank``)."""
        self.mesh.place(rank, "meta")
        return shard_tree(self.args, self.in_shardings)

    def lower(self, rank: int = 0) -> Lowered:
        """The dry run of ``rank``'s program (see the module docstring).
        The plain torch path runs (``kernel_policy(backend="torch")``): a
        hand kernel called through ``ctypes`` is invisible to the counter."""
        t0 = time.perf_counter()
        args = self.local_args(rank)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with collectives.recording() as rec, activation_sharding(self.mesh), \
                kernel_policy(backend="torch"):
            costs = extract_costs(self.fn, *args)
        return Lowered(rec.calls, costs, build_s, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
def count_params_shapes(tree) -> float:
    return float(sum(int(leaf.numel()) for leaf in tree_leaves(tree)))


def count_active_params(cfg: ModelConfig, tree) -> float:
    """MoE: experts count at k/E weight; everything else fully."""
    total = count_params_shapes(tree)
    if cfg.family != "moe" or not cfg.n_experts:
        return total
    expert = 0.0

    def walk(pstr, leaf):
        nonlocal expert
        if "moe/wi_gate" in pstr or "moe/wi_up" in pstr or "moe/wo" in pstr:
            expert += float(leaf.numel())
        return leaf

    tree_map_with_path(walk, tree)
    frac = cfg.experts_per_token / cfg.n_experts
    return total - expert * (1.0 - frac)


def _rep(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _reference_model(cfg: ModelConfig):
    return build_model(cfg, device="cpu")  # init runs under fake tensors only


# ---------------------------------------------------------------------------
# cost reference: the reference's loop-free variant (layers unrolled, naive
# attention, whole-sequence SSD chunk, no microbatching), run once on the
# whole global shapes with no mesh.  Remat is kept, so the backward's
# recompute is counted.  The port runs no loop that a counter sees once, so
# the dry run's own count needs no correction; this keeps the reference's
# record (and its loop_correction arithmetic) comparable.
# ---------------------------------------------------------------------------
def cost_reference(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    ref_cfg = cfg.replace(
        scan_layers=False,
        attn_impl="naive",
        ssm_chunk=max(shape.seq_len, cfg.ssm_chunk),
        train_microbatches=1,
    )
    model = _reference_model(ref_cfg)
    with kernel_policy(backend="torch"):
        if shape.kind == "train":
            opt = AdamW()
            lr_fn = cosine_with_warmup(3e-4, warmup=2000, total=100_000)
            step = make_train_step(model.loss_fn, opt, lr_fn, microbatches=1)
            costs = extract_costs(step, state_shapes(model.init, opt), input_specs(ref_cfg, shape))
        elif shape.kind == "prefill":
            params_sh = state_shapes(model.init, AdamW()).params
            costs = extract_costs(lambda p, b: model.prefill(p, b, shape.seq_len), params_sh,
                                  input_specs(ref_cfg, shape))
        else:
            specs = input_specs(ref_cfg, shape)
            params_sh = state_shapes(model.init, AdamW()).params
            costs = extract_costs(model.decode_step, params_sh, specs["cache"], specs["tokens"],
                                  specs["pos"])
    return {
        "global_flops": costs.flops_per_device,
        "global_bytes_prefusion": costs.bytes_per_device,
        "transcendentals": costs.transcendentals,
    }


# ---------------------------------------------------------------------------
def _local_bytes(tree_shapes, tree_shardings) -> int:
    """Exact per-device bytes of a sharded tree."""
    total = 0
    for leaf, sh in zip(tree_leaves(tree_shapes), tree_leaves(tree_shardings)):
        div = 1
        if isinstance(sh, NamedSharding):
            for ax in sh.spec:
                if ax is None:
                    continue
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    div *= sh.mesh.shape[a]
        total += leaf.numel() * leaf.element_size() // div
    return int(total)


def analytic_memory(cell: "Cell") -> dict:
    """Expected per-device memory.  Exact for state/cache bytes (from the
    actual shardings); formulaic for live activations, as the reference's.
    The saves and the prefill's live activations count S / ``model``: the
    port's transformer holds its stream, and remat its block inputs, split
    on S wherever ``model`` divides it (``tp.split_seq``)."""
    cfg, shape, mesh = cell.cfg, cell.shape, cell.mesh
    amap_dp = 1
    for n in ("pod", "data"):
        if n in mesh.shape:
            amap_dp *= mesh.shape[n]
    tp = mesh.shape.get("model", 1)

    out = {}
    if shape.kind == "train":
        state_sh, batch = cell.args
        state_bytes = _local_bytes(state_sh, cell.in_shardings[0])
        grads = _local_bytes(state_sh.params, cell.in_shardings[0].params)
        b_local = max(shape.global_batch // (amap_dp * cfg.train_microbatches), 1)
        layers = cfg.n_layers
        saves = layers * b_local * shape.seq_len // tp * cfg.d_model * 2
        logits = b_local * shape.seq_len * max(cfg.padded_vocab // tp, 1) * 6
        act_live = int(2.5 * b_local * shape.seq_len * cfg.d_model * 4)  # one-layer bwd
        out = {
            "state_bytes": state_bytes,
            "grad_bytes": grads,
            "saves_bytes": saves,
            "logits_bytes": logits,
            "act_live_bytes": act_live,
            "analytic_peak_bytes": state_bytes + grads + saves + logits + act_live,
        }
    elif shape.kind == "prefill":
        params_sh, batch = cell.args
        pbytes = _local_bytes(params_sh, cell.in_shardings[0])
        cache_sd = build_model(cfg, device="meta").cache_specs(shape.global_batch,
                                                               shape.seq_len)
        cbytes = _local_bytes(cache_sd, cell.out_shardings[1])
        b_local = max(shape.global_batch // amap_dp, 1)
        act = int(3 * b_local * shape.seq_len // tp * cfg.d_model * 2 * 4)
        out = {
            "param_bytes": pbytes,
            "cache_bytes": cbytes,
            "act_live_bytes": act,
            "analytic_peak_bytes": pbytes + 2 * cbytes + act,
        }
    else:  # decode
        params_sh = cell.args[0]
        pbytes = _local_bytes(params_sh, cell.in_shardings[0])
        cbytes = _local_bytes(cell.args[1], cell.in_shardings[1])
        out = {
            "param_bytes": pbytes,
            "cache_bytes": cbytes,
            "analytic_peak_bytes": pbytes + cbytes + (cbytes // 4),
        }
    return out


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Cell:
    model = _reference_model(cfg)
    if shape.kind == "train":
        return _build_train(cfg, shape, mesh, model)
    if shape.kind == "prefill":
        return _build_prefill(cfg, shape, mesh, model)
    return _build_decode(cfg, shape, mesh, model)


def _build_train(cfg, shape, mesh, model) -> Cell:
    opt = AdamW()
    lr_fn = cosine_with_warmup(3e-4, warmup=2000, total=100_000)

    state_sh = state_shapes(model.init, opt)
    # ZeRO staging (dist.zero_layouts): 1 = optimizer state sharded over
    # data; 2 = + grads reduce-scattered into it; 3 = + fp32 params stored in
    # it, gathered a layer at a time where the model uses them
    lay = zero_layouts(state_sh.params, cfg, mesh)
    opt_sh = AdamWState(step=_rep(mesh), mu=lay.moments, nu=lay.moments)
    state_shardings = TrainState(params=lay.params, opt=opt_sh)

    step = make_train_step(
        model.loss_fn,
        opt,
        lr_fn,
        microbatches=cfg.train_microbatches,
        grad_shardings=lay.grads,
        state_shardings=TrainState(lay.params, AdamWState(None, lay.moments, lay.moments)),
    )

    batch = input_specs(cfg, shape)
    # every rank is handed the global batch and takes its rows of each
    # microbatch itself (train/step.py::_rank_batch)
    bshard = tree_map(lambda _: _rep(mesh), batch)
    metrics_sh = {"loss": _rep(mesh), "grad_norm": _rep(mesh), "lr": _rep(mesh)}

    return Cell(
        cfg=cfg,
        shape=shape,
        mesh=mesh,
        fn=step,
        args=(state_sh, batch),
        in_shardings=(state_shardings, bshard),
        out_shardings=(state_shardings, metrics_sh),
        donate=(0,),
        n_params=count_params_shapes(state_sh.params),
        n_params_active=count_active_params(cfg, state_sh.params),
    )


def _serving_params(model):
    """Serving holds bf16 weights (the training fp32 master stays on the
    trainer); float leaves are served in bf16."""
    sd = state_shapes(model.init, AdamW()).params
    return tree_map(lambda leaf: torch.empty(
        leaf.shape, dtype=torch.bfloat16 if leaf.dtype.is_floating_point else leaf.dtype,
        device="meta"), sd)


def _serving_pspecs(params_sh, cfg, mesh):
    pspecs = param_specs(params_sh, cfg, mesh)
    if cfg.serve_param_fsdp:
        pspecs = zero1_state_specs(params_sh, pspecs, mesh)
    return pspecs


def _gathered(step: Callable, pspecs) -> Callable:
    """``step(params, *rest)`` on params stored in ``pspecs``: the leaves a
    layout splits over ``data`` (``serve_param_fsdp``) gathered whole over
    it first (``dist.zero.whole_tree``, each keeping its ``model`` shard);
    ``step`` itself when none is."""
    if not any(zero.data_dim(sh, len(sh.spec)) is not None for sh in tree_leaves(pspecs)):
        return step

    def run(params, *rest):
        with zero.layerwise(params, pspecs):
            return step(zero.whole_tree(params), *rest)

    return run


def _build_prefill(cfg, shape, mesh, model) -> Cell:
    batch = input_specs(cfg, shape)
    params_sh = _serving_params(model)
    pspecs = _serving_pspecs(params_sh, cfg, mesh)
    bshard = batch_shardings(batch, mesh)

    def prefill(params, batch):
        return model.prefill(params, batch, shape.seq_len)

    cache_sd = build_model(cfg, device="meta").cache_specs(shape.global_batch, shape.seq_len)
    lsh = logits_sharding(shape.global_batch, cfg.vocab_size, mesh)
    cshard = cache_shardings(cache_sd, cfg, mesh)

    return Cell(
        cfg=cfg,
        shape=shape,
        mesh=mesh,
        fn=_gathered(prefill, pspecs),
        args=(params_sh, batch),
        in_shardings=(pspecs, bshard),
        out_shardings=(lsh, cshard),
        donate=(),
        n_params=count_params_shapes(params_sh),
        n_params_active=count_active_params(cfg, params_sh),
    )


def _relayout(x: torch.Tensor, have: NamedSharding, want: NamedSharding) -> torch.Tensor:
    """This rank's part of a tensor laid out by ``have``, as ``want`` lays
    it: a dim ``have`` splits and ``want`` does not is gathered (the minor
    axis first), a dim ``want`` splits and ``have`` does not is cut to this
    rank's slice."""
    mesh = have.mesh
    for dim, (h, w) in enumerate(zip(have.dim_axes(x.ndim), want.dim_axes(x.ndim))):
        if h == w:
            continue
        for a in reversed(h):
            x = collectives.all_gather(x, mesh, a, dim)
        if w:
            n, i = 1, 0
            for a in w:
                n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.index(a)
            x = x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)
    return x


def _step_layouts(cfg, shape, cache, cshard, tokens_sh):
    """The layout the decode step takes each cache leaf in.
    ``cache_shardings`` reads dim 1 of every leaf as the lanes; xlstm's
    mLSTM state (L, L', B, ...) and zamba2's ``x0`` (B, d) hold them
    elsewhere.  The step takes each leaf's own lane dim (the dim that grows
    with the batch) split as the tokens are, the batch axes nowhere else,
    and the ``model`` splits as the rule lays them, but for the xLSTM, whose
    blocks read their state whole."""
    lanes = tokens_sh.dim_axes(1)[0]
    more = build_model(cfg, device="meta").cache_specs(shape.global_batch + 1, shape.seq_len)

    def one(leaf, wider, sh):
        lane = next(d for d, (a, b) in enumerate(zip(leaf.shape, wider.shape)) if a != b)
        axes = [tuple(a for a in ax if a == "model" and cfg.family != "ssm")
                for ax in sh.dim_axes(leaf.ndim)]
        axes[lane] = lanes
        return NamedSharding(sh.mesh, P(*(None if not ax else ax[0] if len(ax) == 1 else ax
                                          for ax in axes)))

    return {k: one(leaf, more[k], cshard[k]) for k, leaf in cache.items()}


def _relaid(step: Callable, have, want) -> Callable:
    """``step(params, cache, *rest)`` on a cache laid out by ``have``: each
    leaf laid out by ``want`` for the step and back after it (GSPMD's
    resharding around a step, made explicit); ``step`` itself where the two
    agree."""
    if all(have[k].spec == want[k].spec for k in have):
        return step

    def run(params, cache, *rest):
        out, cache = step(params, {k: _relayout(v, have[k], want[k]) for k, v in cache.items()},
                          *rest)
        return out, {k: _relayout(v, want[k], have[k]) for k, v in cache.items()}

    return run


def _build_decode(cfg, shape, mesh, model) -> Cell:
    specs = input_specs(cfg, shape)
    params_sh = _serving_params(model)
    pspecs = _serving_pspecs(params_sh, cfg, mesh)
    cshard = cache_shardings(specs["cache"], cfg, mesh)
    tp_sh = batch_shardings({"tokens": specs["tokens"], "pos": specs["pos"]}, mesh)
    lsh = logits_sharding(shape.global_batch, cfg.vocab_size, mesh)
    step = _relaid(model.decode_step, cshard,
                   _step_layouts(cfg, shape, specs["cache"], cshard, tp_sh["tokens"]))

    return Cell(
        cfg=cfg,
        shape=shape,
        mesh=mesh,
        fn=_gathered(step, pspecs),
        args=(params_sh, specs["cache"], specs["tokens"], specs["pos"]),
        in_shardings=(pspecs, cshard, tp_sh["tokens"], tp_sh["pos"]),
        out_shardings=(lsh, cshard),
        donate=(1,),
        n_params=count_params_shapes(params_sh),
        n_params_active=count_active_params(cfg, params_sh),
    )
