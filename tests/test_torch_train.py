"""The port's training stack against the reference on the CPU.

``repro_torch.train.make_train_step`` (autograd, in-place AdamW) against
``repro.train.make_train_step`` (``jax.value_and_grad``, jitted) for every
model family at ``reduced()`` size, from the same params (the reference's
init carried across by ``params_from_jax``) and the same numpy batches.
Tolerances, per step: the loss within 1e-5 relative and the grad norm
within 1e-4 relative (fp32 sums taken in another order; measured a few
1e-7, and up to 3.3e-5 for the xLSTM's second step, whose stabilisers and
``max(n, 1)`` are kinks of the loss; from the same params the two packages'
xLSTM grads agree within 1e-5, tested below).  The params and moments
after the steps: each leaf within ``guard.tolerance(float32,
"nvidia-h100-sxm")`` (256 ulps) but for at most 1 % of its elements (at
least one), and every element within a quarter of the summed lr.  The
reason: AdamW's update ``g / (|g| + eps)`` has its steepest slope, 1/eps,
at g = 0, so an element whose grad lies within a few eps of zero turns the
grads' fp32 agreement (a few 1e-9) into up to 0.18 lr of param difference
(measured: one element of the xLSTM's ``w_up`` and one of its sLSTM norm
scale).  A key bias (``bk``) has an exact grad of 0 (softmax is invariant
to a per-query shift), so both packages move it on rounding noise alone:
it is held within the summed lr, the farthest AdamW moves it.
Remat changes no number (equal bit for bit), microbatches=2 equals the
reference's microbatches=2, and a resume after an injected failure is
bit-exact.
"""
import sys
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
from repro.optim.schedule import cosine_with_warmup as jcosine
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as jmake_step
from repro_torch import configs as tconfigs
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import DataPipeline, SyntheticLM
from repro_torch.kernels import api as tapi
from repro_torch.models import build_model
from repro_torch.models import mlp as tmlp
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant, cosine_with_warmup
from repro_torch.train.loop import FailureInjector, LoopConfig, train_loop
from repro_torch.train.step import (TrainState, init_state, make_train_step, state_shapes,
                                    value_and_grad)

_F32 = guard.tolerance(np.float32, "nvidia-h100-sxm")
PARAM_TOL = dict(rtol=_F32.rtol, atol=_F32.atol)
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
LR = 1e-3
# one of each family: dense, MoE (drops forced below), VLM, hybrid, encdec, xLSTM
FAMILIES = ("gemma-2b", "olmoe-1b-7b", "internvl2-76b", "zamba2-7b", "whisper-base",
            "xlstm-1.3b")
BATCH, SEQ = 2, 32


def _cfgs(name, **kw):
    return (jconfigs.get_config(name).reduced().replace(**kw),
            tconfigs.get_config(name).reduced().replace(**kw))


def _jax_params(name, jcfg):
    p = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(0)))
    if name == "olmoe-1b-7b":  # one shared direction: tokens route alike and chunks drop
        p = dict(p)
        rng = np.random.default_rng(3)
        p["embed"] = (p["embed"] + 0.5 * rng.normal(size=jcfg.d_model)).astype(np.float32)
    return p


def _batches(cfg, n, seed=0):
    src = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=seed)
    rng = np.random.default_rng(seed + 100)
    out = []
    for s in range(n):
        b = src.batch_at(s)
        if cfg.family in ("vlm", "encdec"):
            b["frontend"] = rng.normal(size=(BATCH, cfg.frontend_len, cfg.d_model)).astype(
                np.float32)
        out.append(b)
    return out


@lru_cache(maxsize=None)
def _trajectory(name, steps=3, microbatches=1):
    """Both packages' train steps from the same params and batches: per step,
    both packages' metrics and numpy copies of their params and first moments
    after it (the port's step writes in place), and the real tokens'
    assignments the port's MoE dropped.  Cached, so the 1- and 3-step tests
    read one run."""
    jcfg, tcfg = _cfgs(name)
    np_params = _jax_params(name, jcfg)
    jopt, topt = JAdamW(), AdamW()
    jstep = jax.jit(jmake_step(jbuild(jcfg).loss_fn, jopt, jcosine(LR, 0, steps),
                               microbatches=microbatches))
    tstep = make_train_step(build_model(tcfg, device="cpu").loss_fn, topt,
                            cosine_with_warmup(LR, 0, steps), microbatches=microbatches)
    params = jax.tree.map(jnp.asarray, np_params)
    jstate = JTrainState(params, jopt.init(params))
    tparams = params_from_jax(np_params, tcfg, device="cpu")
    tstate = TrainState(tparams, topt.init(tparams))
    drops, block = [], tmlp.moe_block

    def spy(p, x, cfg, *rest):
        drops.append(int(tmlp.moe_drop_count(p, x, cfg)))
        return block(p, x, cfg, *rest)

    records = []
    tmlp.moe_block = spy
    try:
        for b in _batches(tcfg, steps):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
            tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
            copy = lambda tree: jax.tree.map(lambda t: np.array(t), tree)  # noqa: E731
            records.append({"jm": {k: float(v) for k, v in jm.items()},
                            "tm": {k: float(v) for k, v in tm.items()},
                            "jstep": int(jstate.opt.step), "tstep": int(tstate.opt.step),
                            "jparams": copy(jstate.params), "jmu": copy(jstate.opt.mu),
                            "tparams": copy(tstate.params), "tmu": copy(tstate.opt.mu)})
    finally:
        tmlp.moe_block = block
    return records, sum(drops)


def _assert_params_close(tparams, jparams, sum_lr):
    """The rule of the module docstring, leaf by leaf."""
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = jax.tree.leaves(tparams)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        name, err = jax.tree_util.keystr(path), np.abs(g - w)
        if path[-1].key == "bk":  # a zero gradient in exact arithmetic
            assert err.max() <= sum_lr, name
            continue
        outside = int((err > _F32.atol + _F32.rtol * np.abs(w)).sum())
        assert outside <= max(1, w.size // 100), (name, outside, w.size)
        assert err.max() <= 0.25 * sum_lr, (name, err.max())


def _assert_metrics_close(records):
    for r in records:
        j, t = r["jm"], r["tm"]
        assert t["loss"] == pytest.approx(j["loss"], rel=LOSS_RTOL)
        assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=GNORM_RTOL)
        assert t["lr"] == pytest.approx(j["lr"], rel=_F32.rtol)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", FAMILIES)
def test_train_steps_match_reference(name, steps):
    records, drops = _trajectory(name)
    _assert_metrics_close(records[:steps])
    last = records[steps - 1]
    assert last["tstep"] == last["jstep"] == steps
    sum_lr = sum(r["jm"]["lr"] for r in records[:steps])
    _assert_params_close(last["tparams"], last["jparams"], sum_lr)
    _assert_params_close(last["tmu"], last["jmu"], sum_lr)
    if name == "olmoe-1b-7b":  # the real tokens' assignments dropped
        assert drops > 0


def test_xlstm_grads_match_reference_from_the_same_params():
    """The xLSTM's second-step grads, from the port's params after one step
    given to both packages: within 1e-5 of each leaf's largest grad
    (measured 6e-6), so the second step's wider grad-norm spread comes from
    the loss's kinks, not the port."""
    jcfg, tcfg = _cfgs("xlstm-1.3b")
    np_params = _trajectory("xlstm-1.3b")[0][0]["tparams"]
    b = _batches(tcfg, 2)[1]
    jl, jg = jax.value_and_grad(jbuild(jcfg).loss_fn)(jax.tree.map(jnp.asarray, np_params),
                                                      {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = value_and_grad(build_model(tcfg, device="cpu").loss_fn,
                            params_from_jax(np_params, tcfg, device="cpu"),
                            {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    for g, w in zip(jax.tree.leaves(tg), jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_microbatches_match_reference_and_one_batch():
    """microbatches=2 against the reference's microbatches=2, and against the
    port's one batch (the reference's own bounds: the loss within 5e-3, the
    params within 5e-4; the two xent means partition the batch differently)."""
    two, _ = _trajectory("qwen2.5-14b", 2, 2)
    _assert_metrics_close(two)
    _assert_params_close(two[-1]["tparams"], two[-1]["jparams"],
                         sum(r["jm"]["lr"] for r in two))
    one, _ = _trajectory("qwen2.5-14b", 2, 1)
    assert abs(one[0]["tm"]["loss"] - two[0]["tm"]["loss"]) < 5e-3
    d = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree.leaves(one[-1]["tparams"]),
                                                        jax.tree.leaves(two[-1]["tparams"])))
    assert d < 5e-4, d


@pytest.mark.parametrize("name,policy", [("gemma-2b", "full"), ("gemma-2b", "dots"),
                                         ("olmoe-1b-7b", "dots"), ("zamba2-7b", "full"),
                                         ("whisper-base", "full"), ("xlstm-1.3b", "full")])
def test_remat_changes_no_number(name, policy):
    """The loss and every grad with remat equal those without, bit for bit."""
    jcfg, tcfg = _cfgs(name)
    np_params = _jax_params(name, jcfg)
    b = {k: torch.from_numpy(v) for k, v in _batches(tcfg, 1)[0].items()}
    out = {}
    for remat in (False, True):
        cfg = tcfg.replace(remat=remat, remat_policy=policy)
        params = params_from_jax(np_params, cfg, device="cpu")
        out[remat] = value_and_grad(build_model(cfg, device="cpu").loss_fn, params, b)
    assert torch.equal(out[True][0], out[False][0])
    for g1, g0 in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(g1, g0)


def test_remat_checkpoints_each_block_only_under_grad(monkeypatch):
    from torch.utils import checkpoint as ckpt

    calls = []
    real = ckpt.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(ckpt, "checkpoint", spy)
    _, tcfg = _cfgs("gemma-2b", remat=True)
    model = build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in _batches(tcfg, 1)[0].items()}
    with torch.no_grad():
        model.loss_fn(params, b)
    assert calls == []
    value_and_grad(model.loss_fn, params, b)
    assert calls == [False] * tcfg.n_layers


def test_value_and_grad_gives_zeros_to_an_unused_leaf():
    params = {"w": torch.ones(3), "unused": torch.ones(2)}
    loss, grads = value_and_grad(lambda p, b: (p["w"] * b).sum(), params, torch.arange(3.0))
    assert float(loss) == 3.0 and torch.equal(grads["w"], torch.arange(3.0))
    assert torch.equal(grads["unused"], torch.zeros(2))
    assert not any(p.requires_grad for p in params.values())


def test_grad_shardings_wait_for_the_distribution_layer():
    """ZeRO-2's grad layout comes with the state's layouts (the data-parallel
    step, ``tests/test_torch_zero.py``); alone it is refused."""
    with pytest.raises(ValueError, match="state_shardings"):
        make_train_step(lambda p, b: 0.0, AdamW(), constant(1e-3), grad_shardings={})


def test_state_shapes_are_meta_and_match_init():
    _, tcfg = _cfgs("gemma-2b")
    model = build_model(tcfg, device="cpu")
    shapes = state_shapes(model.init, AdamW())
    real = init_state(model.init, AdamW(), torch.Generator().manual_seed(0))
    got, want = tree_leaves(shapes), tree_leaves(real)
    assert len(got) == len(want) and all(t.device.type == "meta" for t in got)
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
    full = state_shapes(build_model(tconfigs.get_config("gemma-2b"), device="cpu").init, AdamW())
    assert sum(t.numel() for t in tree_leaves(full.params)) == tconfigs.get_config(
        "gemma-2b").param_count()


def test_a_hand_kernel_under_autograd_raises():
    """With the cuda backend asked for, the flash kernel would sit in the
    graph without a backward: the call raises before any device work, where
    the same call without grad meets the device check."""
    _, tcfg = _cfgs("gemma-2b", attn_impl="pallas")
    model = build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in _batches(tcfg, 1)[0].items()}
    with tapi.kernel_policy(backend="cuda"):
        with pytest.raises(NotImplementedError, match="flash_attention.*no backward"):
            value_and_grad(model.loss_fn, params, b)
        with pytest.raises(ValueError, match="needs CUDA tensors"), torch.no_grad():
            model.loss_fn(params, b)
    # the plain path trains: the same step on backend torch (the CPU's own)
    loss, _ = value_and_grad(model.loss_fn, params, b)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("op,args", [
    ("matmul", lambda: (torch.randn(8, 8, requires_grad=True), torch.randn(8, 8))),
    ("ssm_scan", lambda: (torch.randn(1, 16, 2, 4, requires_grad=True), torch.randn(1, 16, 2),
                          torch.randn(1, 16, 4), torch.randn(1, 16, 4))),
    ("flash_attention", lambda: tuple(torch.randn(1, 16, 2, 16, requires_grad=i == 0)
                                      for i in range(3))),
])
def test_each_model_kernel_refuses_autograd(op, args):
    fn = getattr(tapi, op)
    with pytest.raises(NotImplementedError, match=f"{op}.*Pallas kernel either"):
        fn(*args(), backend="cuda")
    with pytest.raises(NotImplementedError, match=op), tapi.kernel_policy(guard="shadow"):
        fn(*args(), backend="cuda")
    out = fn(*args(), backend="torch")  # the oracle stays differentiable
    assert out.requires_grad


# ---------------------------------------------------------------------------
# the loop: resume and the end-to-end loss drop
# ---------------------------------------------------------------------------
def test_train_resume_exact(tmp_path):
    """Kill training at step 6, resume, and hold the final state and the
    resumed losses equal, bit for bit, to an uninterrupted run."""
    cfg = tconfigs.get_config("qwen2.5-14b").reduced().replace(
        n_layers=1, d_model=32, d_ff=64, n_heads=2, n_kv_heads=2, head_dim=16, vocab_size=64)
    model = build_model(cfg, device="cpu")
    opt = AdamW()
    step_fn = make_train_step(model.loss_fn, opt, constant(1e-3))
    src = SyntheticLM(cfg.vocab_size, 16, 4, seed=0)

    def fresh_state():
        return init_state(model.init, opt, torch.Generator().manual_seed(0))

    loop_cfg = LoopConfig(total_steps=10, ckpt_every=3)
    ref_state, ref_hist = train_loop(step_fn, fresh_state(),
                                     DataPipeline(src.batch_at, device="cpu", prefetch=0),
                                     ckpt=None, cfg=loop_cfg)
    ckpt = CheckpointManager(tmp_path / "ft")
    with pytest.raises(RuntimeError, match="injected failure"):
        train_loop(step_fn, fresh_state(), DataPipeline(src.batch_at, device="cpu", prefetch=0),
                   ckpt=ckpt, cfg=loop_cfg, injector=FailureInjector(fail_at_step=6))
    assert ckpt.steps() == [3, 6]
    res_state, res_hist = train_loop(step_fn, fresh_state(),
                                     DataPipeline(src.batch_at, device="cpu", prefetch=2),
                                     ckpt=ckpt, cfg=loop_cfg)
    for a, b in zip(tree_leaves(ref_state), tree_leaves(res_state)):
        assert torch.equal(a, b)
    assert res_hist[0]["step"] == 6
    assert [r["loss"] for r in ref_hist[6:]] == [r["loss"] for r in res_hist]
    assert ckpt.steps()[-1] == 10


def test_training_reduces_loss_e2e():
    """The counterpart of the reference's ``test_training_reduces_loss_e2e``:
    40 steps on the synthetic stream lower the mean loss by more than 0.2."""
    cfg = tconfigs.get_config("qwen2.5-14b").reduced()
    model = build_model(cfg, device="cpu")
    opt = AdamW(weight_decay=0.0)
    step_fn = make_train_step(model.loss_fn, opt, cosine_with_warmup(3e-3, 5, 60))
    state = init_state(model.init, opt, torch.Generator().manual_seed(0))
    src = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=8, seed=0)
    pipe = DataPipeline(src.batch_at, device="cpu", prefetch=2)
    try:
        state, hist = train_loop(step_fn, state, pipe, ckpt=None,
                                 cfg=LoopConfig(total_steps=40))
    finally:
        pipe.close()
    assert hist[0]["lr"] == 0.0  # warmup's step 0
    first = np.mean([h["loss"] for h in hist[1:6]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)


def test_launch_train_reduces_the_loss_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    hist = launch_train.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps",
                              "12", "--batch", "4", "--seq", "32", "--lr", "3e-3",
                              "--ckpt-dir", str(tmp_path), "--ckpt-every", "6"])
    out = capsys.readouterr().out
    assert "gemma-2b-smoke:" in out and "final loss" in out
    assert len(hist) == 12 and hist[-1]["loss"] < hist[1]["loss"]
    assert CheckpointManager(tmp_path).steps() == [6, 12]
    # a longer rerun resumes from the last checkpoint
    more = launch_train.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps",
                              "14", "--batch", "4", "--seq", "32", "--lr", "3e-3",
                              "--ckpt-dir", str(tmp_path), "--ckpt-every", "6"])
    assert [h["step"] for h in more] == [12, 13]


@pytest.mark.parametrize("arch", ["internvl2-76b", "xlstm-1.3b"])
def test_launch_train_other_families_on_the_cpu(arch, capsys):
    from repro_torch.launch import train as launch_train

    hist = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                              "--batch", "2", "--seq", "16", "--microbatches", "2"])
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)


def test_launch_train_without_a_card_exits_nonzero():
    import subprocess
    from pathlib import Path

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default --device cuda would train on it")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                           "gemma-2b", "--reduced", "--steps", "2"], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and "no CUDA device is visible" in proc.stderr
    assert "params" not in proc.stdout

