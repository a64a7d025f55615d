"""One training step of the hybrid, xLSTM, encoder-decoder and VLM families
on a (data 2, model 2) mesh at ZeRO stages 1, 2 and 3, the port against the
reference's jitted ``make_train_step`` on the whole batch, on four gloo CPU
ranks.

zamba2-7b, xlstm-1.3b and whisper-base gather their stored ZeRO-3 leaves
whole over ``data`` before the forward (``models/api.py::_whole``), keeping
each leaf's ``model`` shard; internvl2-76b, a decoder, gathers a layer at a
time inside its blocks.  The loss within 1e-5, the grad norm within 1e-4,
the params under ``tests/test_torch_train.py``'s rule
(``tests/test_torch_tp_train.py::_train_rule``), on every rank.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.optim import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.models import build_model as jbuild
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as jmake_step
from repro_torch.dist import run_ranks

import torch_dist_workers as workers
import torch_tp_families as F

LR = 1e-3
NAMES = ("zamba2-7b", "xlstm-1.3b", "whisper-base", "internvl2-76b")
STAGES = (1, 2, 3)


def _batch(name):
    return F.batch(name, b=4, s=16, seed=3)


@lru_cache(maxsize=None)
def _steps():
    runs = [(name, stage, F.np_params(name), _batch(name), {})
            for name in NAMES for stage in STAGES]
    res = run_ranks(workers.tp_train_steps, 4, runs, LR, None, device="cpu", timeout=300)
    return {(name, stage): [r[i] for r in res] for i, (name, stage, *_) in enumerate(runs)}


@lru_cache(maxsize=None)
def _ref_step(name):
    cfg = F.jcfg(name, ())
    opt = JAdamW()
    step = jax.jit(jmake_step(jbuild(cfg).loss_fn, opt, jconstant(LR),
                              microbatches=cfg.train_microbatches))
    params = jax.tree.map(jnp.asarray, F.np_params(name))
    state, m = step(JTrainState(params, opt.init(params)),
                    {k: jnp.asarray(v) for k, v in _batch(name).items()})
    return {k: float(v) for k, v in m.items()}, jax.tree.map(np.asarray, state.params)


def _train_rule(got, want, sum_lr):
    """tests/test_torch_train.py's rule for params after AdamW steps."""
    for (path, a), (_, b) in zip(F.leaves(got), F.leaves(want)):
        err = np.abs(a - b)
        outside = int((err > F.TOL["atol"] + F.TOL["rtol"] * np.abs(b)).sum())
        assert outside <= max(1, b.size // 100), (path, outside, b.size)
        assert float(err.max()) <= 0.25 * sum_lr, (path, float(err.max()))


@pytest.mark.parametrize("name,stage", [(n, s) for n in NAMES for s in STAGES])
def test_2d_step_matches_the_reference_step(name, stage):
    jm, jparams = _ref_step(name)
    ranks = _steps()[(name, stage)]
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], jm["grad_norm"], rtol=1e-4)
        _train_rule(r["params"], jparams, LR)
    if stage == 3:  # each rank stores half of its model part of a leaf split over data
        stored = dict(F.leaves(ranks[0]["stored_shapes"]))
        local = dict(F.leaves(ranks[0]["local_shapes"]))
        assert any(np.prod(stored[k]) < np.prod(local[k]) for k in local)
