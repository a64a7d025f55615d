"""ZeRO data parallelism of the port against its unsharded step and the
reference's, on 2 gloo CPU ranks.

gemma-2b and olmoe-1b-7b at ``reduced()``, ZeRO stages 1–3 on a (data=2,
model=1) mesh: ``dist.zero_layouts`` places the state, each rank takes its
half of the global batch, and ``make_train_step(state_shardings=...,
grad_shardings=...)`` averages the grads (reduce-scattered at stage 2 and
above), clips by the global norm over every shard and updates the local
shards.  Tolerances: the loss and grad norm within ``guard.tolerance(float32,
"nvidia-h100-sxm")``'s rtol (256 ulps), every param and first-moment leaf
within that tolerance, against the unsharded port step on the same global
batch; against the reference's step, the rule of ``tests/test_torch_train.py``
(AdamW's 1/eps slope at a zero grad).

The MoE aux loss is not linear in the batch: its router statistics are
means over the global batch (``dist.data_parallel.batch_mean`` across the
data ranks), so olmoe's data-parallel step is the step on the whole batch,
the reference's and the unsharded port's.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import guard
from repro.models import build_model as jbuild
from repro.optim import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as jmake_step
from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLM
from repro_torch.dist import run_ranks
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.common import tree_map
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train.step import TrainState, make_train_step

import torch_dist_workers as workers

_F32 = guard.tolerance(np.float32, "nvidia-h100-sxm")
LR = 1e-3
BATCH, SEQ = 4, 32
NAMES = ("gemma-2b", "olmoe-1b-7b")
STAGES = (1, 2, 3)
WHOLE = ("zamba2-7b", "xlstm-1.3b")  # families whose ZeRO-3 params are gathered whole


def _np_params(name):
    cfg = jconfigs.get_config(name).reduced()
    return jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.key(0)))


def _batch(name, step=0):
    cfg = tconfigs.get_config(name).reduced()
    return SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0).batch_at(step)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


@lru_cache(maxsize=None)
def _sharded():
    """Every (name, stage) run on 2 ranks in one spawn: {(name, stage):
    [rank 0's result, rank 1's]}."""
    runs = ([(n, s, _np_params(n), [_batch(n)]) for n in NAMES for s in STAGES]
            + [(n, 3, _np_params(n), [_batch(n)]) for n in WHOLE])
    res = run_ranks(workers.zero_steps, 2, runs, LR, device="cpu", timeout=300)
    return {(n, s): [res[0][i], res[1][i]] for i, (n, s, _, _) in enumerate(runs)}


def _port_step(name):
    """The unsharded port step on the global batch: (metrics, params, mu)."""
    cfg = tconfigs.get_config(name).reduced()
    model = build_model(cfg, device="cpu")
    params = params_from_jax(_np_params(name), cfg, device="cpu")
    opt = AdamW()
    step = make_train_step(model.loss_fn, opt, constant(LR))
    state, m = step(TrainState(params, opt.init(params)),
                    {k: torch.from_numpy(v) for k, v in _batch(name).items()})
    np_tree = lambda t: tree_map(lambda x: x.numpy(), t)  # noqa: E731
    return {k: float(v) for k, v in m.items()}, np_tree(state.params), np_tree(state.opt.mu)


def _ref_step(name):
    cfg = jconfigs.get_config(name).reduced()
    opt = JAdamW()
    step = jax.jit(jmake_step(jbuild(cfg).loss_fn, opt, jconstant(LR)))
    params = jax.tree.map(jnp.asarray, _np_params(name))
    state, m = step(JTrainState(params, opt.init(params)),
                    {k: jnp.asarray(v) for k, v in _batch(name).items()})
    return {k: float(v) for k, v in m.items()}, jax.tree.map(np.asarray, state.params)


def _within_tolerance(got, want, what):
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=_F32.rtol, atol=_F32.atol,
                                   err_msg=f"{what}: {path}")


def _train_rule(got, want, sum_lr):
    """tests/test_torch_train.py's rule for params after AdamW steps."""
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        err = np.abs(a - b)
        outside = int((err > _F32.atol + _F32.rtol * np.abs(b)).sum())
        assert outside <= max(1, b.size // 100), (path, outside, b.size)
        assert float(err.max()) <= 0.25 * sum_lr, (path, float(err.max()))


@pytest.mark.parametrize("stage", STAGES)
def test_zero_gemma_matches_the_unsharded_step(stage):
    r0, r1 = _sharded()[("gemma-2b", stage)]
    m, params, mu = _port_step("gemma-2b")
    for r in (r0, r1):  # every rank ends with the same state
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(r["metrics"][0][k], m[k], rtol=_F32.rtol, err_msg=k)
        _within_tolerance(r["params"], params, f"stage {stage} params")
        _within_tolerance(r["mu"], mu, f"stage {stage} mu")
    # the moments live halved on each rank; the params too at stage 3
    vocab, d = params["embed"].shape
    assert r0["local_shapes"][1] == (vocab // 2, d)
    assert r0["local_shapes"][0] == ((vocab // 2, d) if stage == 3 else (vocab, d))


@pytest.mark.parametrize("stage", STAGES)
def test_zero_gemma_matches_the_reference_step(stage):
    r0, _ = _sharded()[("gemma-2b", stage)]
    jm, jparams = _ref_step("gemma-2b")
    np.testing.assert_allclose(r0["metrics"][0]["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["metrics"][0]["grad_norm"], jm["grad_norm"], rtol=1e-4)
    _train_rule(r0["params"], jparams, LR)


@pytest.mark.parametrize("stage", STAGES)
def test_zero_olmoe_matches_the_whole_batch_step(stage):
    """The MoE's data-parallel step takes its aux loss over the whole batch:
    it equals the unsharded port step and the reference's step on it."""
    r0, r1 = _sharded()[("olmoe-1b-7b", stage)]
    m, params, mu = _port_step("olmoe-1b-7b")
    jm, jparams = _ref_step("olmoe-1b-7b")
    for r in (r0, r1):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][0][k], m[k], rtol=_F32.rtol, err_msg=k)
        _within_tolerance(r["params"], params, f"stage {stage} params")
        _within_tolerance(r["mu"], mu, f"stage {stage} mu")
        np.testing.assert_allclose(r["metrics"][0]["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["metrics"][0]["grad_norm"], jm["grad_norm"], rtol=1e-4)
        _train_rule(r["params"], jparams, LR)


@pytest.mark.parametrize("name", WHOLE)
def test_zero3_families_without_layer_gathers_take_their_params_whole(name):
    """A family whose forward has no layer-wise gathers (``models/api.py``
    gathers its stored ZeRO-3 params whole at the entry): its stage-3 step
    equals the unsharded step."""
    m, params, mu = _port_step(name)
    for r in _sharded()[(name, 3)]:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][0][k], m[k], rtol=_F32.rtol, err_msg=k)
        _within_tolerance(r["params"], params, f"{name} params")
        _within_tolerance(r["mu"], mu, f"{name} mu")


EXTRA = {"whole-over-data-read-directly": ((3, 5), False),
         "split-read-through-whole": ((4, 3), True),
         "split-read-directly": ((4, 3), False)}


@lru_cache(maxsize=None)
def _extra_leaf():
    res = run_ranks(workers.zero3_extra_leaf, 2, list(EXTRA.values()), LR, device="cpu",
                    timeout=120)
    return {case: [r[i] for r in res] for i, case in enumerate(EXTRA)}


@pytest.mark.parametrize("case", list(EXTRA))
def test_zero3_step_sums_a_leaf_read_outside_the_layer_gathers(case):
    """A stored leaf the model reads outside ``layer_list``: kept whole over
    ``data`` (no dim of 3 x 5 divides 2), read directly, the step sums its
    gradient over the data ranks itself; split over ``data`` and taken
    through ``dist.zero.whole``, its gather's backward does; split and read
    directly (its shard alone), the step raises rather than update it with
    this rank's part of its gradient."""
    for r in _extra_leaf()[case]:
        if case == "split-read-directly":
            assert "extra" in r["error"] and "without gathering" in r["error"], r
            continue
        assert r["data_dim"] == (None if case.startswith("whole") else 0)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][k], r["one_metrics"][k], rtol=_F32.rtol)
        for k in ("extra", "embed"):
            _within_tolerance(r["params"][k], r["one_params"][k], f"{case}: {k}")


def test_zero_layouts_follow_the_stage():
    from repro_torch.dist import zero_layouts
    from repro_torch.train.step import state_shapes

    mesh = Mesh((2, 1), ("data", "model"))
    shapes = state_shapes(build_model(tconfigs.get_config("gemma-2b").reduced(),
                                      device="cpu").init, AdamW()).params
    for stage in (0, 1, 2, 3):
        cfg = tconfigs.get_config("gemma-2b").reduced().replace(zero_stage=stage)
        lay = zero_layouts(shapes, cfg, mesh)
        spec = lambda tree: tuple(tree["embed"].spec)  # noqa: E731
        assert spec(lay.params) == (("data", None) if stage == 3 else (None, None))
        assert spec(lay.moments) == (("data", None) if stage >= 1 else (None, None))
        assert (lay.grads is None) == (stage < 2)
