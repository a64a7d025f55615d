"""Training on a (data, model) mesh, the port against the reference, on gloo
CPU ranks.

gemma-2b ``reduced()`` (4 query heads split 2 a rank, 1 KV head kept whole,
the tied vocab-split embedding, 2 microbatches) and olmoe-1b-7b
``reduced()`` (2 KV heads split, 4 experts 2 a rank, the replicated
router, an untied vocab-split ``lm_head``), in float32, from the reference's
weights (``params_from_jax``).

- **Gradients**: one ``value_and_grad`` on (data=1, model=2) of these and
  of qwen2.5-14b ``reduced()`` (whose replicated q/k/v biases each rank
  cuts to its heads), with
  Megatron's conjugate collectives in the backward: every rank's grad of
  every leaf equals its slice of the reference's one-device ``jax.grad``
  (the whole of it for a replicated leaf) within ``guard.tolerance(float32,
  "nvidia-h100-sxm")``.  gemma-2b also runs with remat, both policies.  The
  three places a naive ``copy`` breaks sit in these configs: the whole KV
  head read by the local query heads, the router feeding the replicated
  aux loss and the split combine, and the tied embedding read by the lookup
  and the head.
- **Steps**: one step on (data=2, model=2) at ZeRO stages 1, 2 and 3
  against the reference's jitted ``make_train_step`` on the whole batch
  (the config's microbatches): the loss within 1e-5, the grad norm within
  1e-4, the params under ``tests/test_torch_train.py``'s rule.  For the MoE
  that holds the aux loss to the global batch's router statistics, taken
  in each microbatch (olmoe at 2 microbatches too).
- **ZeRO-3 a layer at a time**: every tensor ``dist.zero`` gathers in a
  stage-3 step is one layer's slice of a leaf or a whole non-layer leaf,
  with the layer dim on ``data`` (2 layers) and an inner dim on it (3
  layers), and the step equals stage 1's.
- **The 2-D ZeRO-3 checkpoint**: saved from its shards, restored on one
  rank (``ckpt/reshard.py``) equal to the gathered state, and restored by
  the reference's ``CheckpointManager``.

Each model's steps run in one spawn of 4 ranks, the gradients of both in
one spawn of 2, cached across the tests.
"""
import tempfile
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.kernels import guard
from repro.models import build_model as jbuild
from repro.optim import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as jmake_step
from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLM
from repro_torch.dist import run_ranks

import torch_dist_workers as workers

_F32 = guard.tolerance(np.float32, "nvidia-h100-sxm")
LR = 1e-3
BATCH, SEQ = 4, 32
NAMES = ("gemma-2b", "olmoe-1b-7b")
STAGES = (1, 2, 3)
GRAD_CASES = {"gemma-2b": ("gemma-2b", {}),
              "gemma-2b-remat-full": ("gemma-2b", {"remat": True}),
              "gemma-2b-remat-dots": ("gemma-2b", {"remat": True, "remat_policy": "dots"}),
              "olmoe-1b-7b": ("olmoe-1b-7b", {}),
              "qwen2.5-14b": ("qwen2.5-14b", {})}
# each model's step runs: (zero stage, config overrides); gemma's last is the
# stage-3 run whose state is checkpointed
STEP_RUNS = {"gemma-2b": ((1, {}), (2, {}), (1, {"n_layers": 3}), (3, {"n_layers": 3}),
                          (3, {})),
             "olmoe-1b-7b": ((1, {}), (2, {}), (3, {}), (1, {"train_microbatches": 2}))}
_CKPT = {}  # the gemma spawn's checkpoint directory, alive while the module runs


def _jcfg(name, **kw):
    return jconfigs.get_config(name).reduced().replace(**kw)


@lru_cache(maxsize=None)
def _np_params(name, n_layers=None):
    kw = {} if n_layers is None else {"n_layers": n_layers}
    return jax.tree.map(np.asarray, jbuild(_jcfg(name, **kw)).init(jax.random.key(0)))


@lru_cache(maxsize=None)
def _batch():
    """One global batch for both models (both reduced vocabs are 256)."""
    cfg = tconfigs.get_config("gemma-2b").reduced()
    return SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0).batch_at(0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


@lru_cache(maxsize=None)
def _grads():
    cases = [(name, _np_params(name), kw) for name, kw in GRAD_CASES.values()]
    res = run_ranks(workers.tp_grads, 2, cases, _batch(), device="cpu", timeout=300)
    return {case: [r[i] for r in res] for i, case in enumerate(GRAD_CASES)}


@lru_cache(maxsize=None)
def _ref_grads(name):
    loss, grads = jax.value_and_grad(jbuild(_jcfg(name)).loss_fn)(
        jax.tree.map(jnp.asarray, _np_params(name)),
        {k: jnp.asarray(v) for k, v in _batch().items()})
    return float(loss), jax.tree.map(np.asarray, grads)


@lru_cache(maxsize=None)
def _steps(name):
    """Every rank's result of each of the model's step runs, in order."""
    runs = [(name, stage, _np_params(name, kw.get("n_layers")), _batch(), kw)
            for stage, kw in STEP_RUNS[name]]
    ckpt = None
    if name == "gemma-2b":
        _CKPT["dir"] = tempfile.TemporaryDirectory(prefix="tp_train_ckpt_")
        ckpt = _CKPT["dir"].name
    res = run_ranks(workers.tp_train_steps, 4, runs, LR, ckpt, device="cpu", timeout=300)
    return [[r[i] for r in res] for i in range(len(runs))]


@lru_cache(maxsize=None)
def _ref_step(name, microbatches):
    cfg = _jcfg(name)
    opt = JAdamW()
    step = jax.jit(jmake_step(jbuild(cfg).loss_fn, opt, jconstant(LR),
                              microbatches=microbatches))
    params = jax.tree.map(jnp.asarray, _np_params(name))
    state, m = step(JTrainState(params, opt.init(params)),
                    {k: jnp.asarray(v) for k, v in _batch().items()})
    return {k: float(v) for k, v in m.items()}, jax.tree.map(np.asarray, state.params)


def _train_rule(got, want, sum_lr):
    """tests/test_torch_train.py's rule for params after AdamW steps."""
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        err = np.abs(a - b)
        outside = int((err > _F32.atol + _F32.rtol * np.abs(b)).sum())
        assert outside <= max(1, b.size // 100), (path, outside, b.size)
        assert float(err.max()) <= 0.25 * sum_lr, (path, float(err.max()))


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_tp_grads_equal_the_references_slices(case):
    name, _ = GRAD_CASES[case]
    want_loss, want = _ref_grads(name)
    for rank, r in enumerate(_grads()[case]):
        np.testing.assert_allclose(r["loss"], want_loss, rtol=1e-5)
        for (path, g), (_, sl), (_, w) in zip(_leaves(r["grads"]), _leaves(r["slices"]),
                                             _leaves(want)):
            np.testing.assert_allclose(g, w[tuple(slice(a, b) for a, b in sl)],
                                       rtol=_F32.rtol, atol=_F32.atol,
                                       err_msg=f"{case} rank {rank}: {path}")


def test_the_three_traps_sit_in_the_tested_configs():
    """The whole KV head with split query heads, the replicated router with
    split experts, and the tied vocab-split embedding: each rank's slices."""
    gemma = _grads()["gemma-2b"][1]["slices"]
    cfg = tconfigs.get_config("gemma-2b").reduced()
    assert cfg.n_kv_heads == 1 and cfg.tie_embeddings and "lm_head" not in gemma
    assert gemma["layers"]["attn"]["wk"][2] == (0, 1)  # the KV head whole
    assert gemma["layers"]["attn"]["wq"][2] == (2, 4)  # rank 1's query heads
    assert gemma["embed"][0] == (cfg.padded_vocab // 2, cfg.padded_vocab)
    olmoe = _grads()["olmoe-1b-7b"][1]["slices"]["layers"]["moe"]
    assert olmoe["router"][2] == (0, 4)  # every expert's logit on every rank
    assert olmoe["wi_gate"][1] == (2, 4)  # rank 1's experts
    qwen = _grads()["qwen2.5-14b"][1]["slices"]["layers"]["attn"]
    assert qwen["bk"][1] == (0, 2) and qwen["wk"][2] == (1, 2)  # the biases whole, cut per rank


@pytest.mark.parametrize("name,stage", [(n, s) for n in NAMES for s in STAGES])
def test_2d_step_matches_the_reference_step(name, stage):
    i = [s for s, kw in STEP_RUNS[name]].index(stage)
    if name == "gemma-2b" and stage == 3:
        i = len(STEP_RUNS[name]) - 1  # the full-depth stage-3 run
    ranks = _steps(name)[i]
    jm, jparams = _ref_step(name, jconfigs.get_config(name).train_microbatches)
    for r in ranks:  # every rank ends with the same state
        np.testing.assert_allclose(r["metrics"]["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], jm["grad_norm"], rtol=1e-4)
        _train_rule(r["params"], jparams, LR)
    # each rank stores a quarter of the split leaves at stage 3 (a half over
    # model, a half of that over data), else its model half
    shapes = dict(_leaves(ranks[0]["stored_shapes"]))
    local = dict(_leaves(ranks[0]["local_shapes"]))
    assert all(np.prod(shapes[k]) == (np.prod(local[k]) // 2 if stage == 3 else np.prod(local[k]))
               for k in local)


def test_2d_step_takes_the_aux_loss_per_global_microbatch():
    """olmoe at 2 microbatches: each rank's local microbatch i is its share
    of the global microbatch i, whose router statistics the aux loss takes."""
    i = [kw.get("train_microbatches") for _, kw in STEP_RUNS["olmoe-1b-7b"]].index(2)
    jm, jparams = _ref_step("olmoe-1b-7b", 2)
    for r in _steps("olmoe-1b-7b")[i]:
        np.testing.assert_allclose(r["metrics"]["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], jm["grad_norm"], rtol=1e-4)
        _train_rule(r["params"], jparams, LR)


@pytest.mark.parametrize("layers", [2, 3], ids=["layer-dim-on-data", "inner-dim-on-data"])
def test_zero3_gathers_one_layer_at_a_time(layers):
    runs = _steps("gemma-2b")
    stage = {s: runs[i] for i, (s, kw) in enumerate(STEP_RUNS["gemma-2b"])
             if kw.get("n_layers", 2) == layers}
    cfg = tconfigs.get_config("gemma-2b").reduced().replace(n_layers=layers)
    for r3, r1 in zip(stage[3], stage[1]):
        local = dict(_leaves(r3["local_shapes"]))
        layer = {k: s[1:] for k, s in local.items() if k.startswith("/layers/")}
        other = {k: s for k, s in local.items() if not k.startswith("/layers/")}
        allowed = set(layer.values()) | set(other.values())
        largest = max(np.prod(s) for s in allowed)
        assert largest == np.prod(local["/embed"])  # the embedding, model-local
        # per microbatch: each layer's leaves, the embedding twice (the
        # lookup and the tied head) and the final norm
        assert len(r3["gathered"]) == cfg.train_microbatches * (layers * len(layer) + 3)
        assert set(r3["gathered"]) <= allowed, set(r3["gathered"]) - allowed
        assert r1["gathered"] == []
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r3["metrics"][k], r1["metrics"][k], rtol=_F32.rtol)
        for (path, a), (_, b) in zip(_leaves(r3["params"]), _leaves(r1["params"])):
            np.testing.assert_allclose(a, b, rtol=_F32.rtol, atol=_F32.atol, err_msg=path)


def test_2d_zero3_checkpoint_restores_on_one_rank_and_in_the_reference():
    state = _steps("gemma-2b")[-1][0]["state"]
    like = {"params": jax.tree.map(np.shape, state.params),
            "mu": jax.tree.map(np.shape, state.opt.mu),
            "nu": jax.tree.map(np.shape, state.opt.nu)}
    directory = _CKPT["dir"].name
    ((step, got),) = run_ranks(workers.restore_on_one, 1, directory, like, device="cpu",
                               timeout=120)
    assert step == 1
    for (path, a), (_, b) in zip(_leaves({"p": got.params, "m": got.opt.mu, "n": got.opt.nu}),
                                 _leaves({"p": state.params, "m": state.opt.mu,
                                          "n": state.opt.nu})):
        np.testing.assert_array_equal(a, b, err_msg=path)
    assert int(got.opt.step) == int(state.opt.step) == 1
    params = jax.tree.map(jnp.asarray, _np_params("gemma-2b"))
    jlike = jax.eval_shape(lambda: JTrainState(params, JAdamW().init(params)))
    jstep, back = JCheckpointManager(directory).restore(jlike)
    assert jstep == 1
    np.testing.assert_array_equal(np.asarray(back.params["embed"]), state.params["embed"])
    np.testing.assert_array_equal(np.asarray(back.opt.nu["layers"]["mlp"]["wo"]),
                                  state.opt.nu["layers"]["mlp"]["wo"])
