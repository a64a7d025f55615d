"""The port's optimizer, schedules, clipping and data pipeline against the
reference on the CPU.

The same numpy inputs go through ``repro.optim`` / ``repro.data`` (JAX) and
``repro_torch.optim`` / ``repro_torch.data``.  Tolerances:
``repro.kernels.guard.tolerance(float32, "nvidia-h100-sxm")`` (256 ulps) for
AdamW's moments, updates and params over several steps, the clip and the
schedules (the same operations in the same order; only ``b ** step`` and the
norm's summation order may round differently); ``SyntheticLM`` and
``zipf_tokens`` bit for bit (the port keeps its own copy of the numpy code).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataPipeline as JPipeline
from repro.data import SyntheticLM as JSynth
from repro.data import zipf_tokens as jzipf
from repro.kernels import guard
from repro.optim import AdamW as JAdamW
from repro.optim import clip_by_global_norm as jclip
from repro.optim.schedule import constant as jconstant
from repro.optim.schedule import cosine_with_warmup as jcosine
from repro_torch.data import DataPipeline, SyntheticLM, zipf_tokens
from repro_torch.optim import AdamW, clip_by_global_norm, constant, cosine_with_warmup, global_norm

_TOL = guard.tolerance(np.float32, "nvidia-h100-sxm")
TOL = dict(rtol=_TOL.rtol, atol=_TOL.atol)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"embed": (rng.normal(size=(16, 8)) * scale).astype(np.float32),
            "layers": {"w": (rng.normal(size=(3, 8, 4)) * scale).astype(np.float32),
                       "norm": {"scale": (1 + 0.1 * rng.normal(size=(3, 8))).astype(np.float32)}},
            "bias": (rng.normal(size=(5,)) * scale).astype(np.float32)}


def _torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(got_tree, want_tree, **tol):
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got_tree))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **(tol or TOL))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, dict(b1=0.8, b2=0.999, eps=1e-6, weight_decay=0.0),
                                dict(weight_decay=0.01)])
def test_adamw_matches_reference_over_steps(kw):
    """Five steps of update + apply from the same params and grads, leaf by
    leaf: the moments, the updates, the params and the int32 step."""
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jparams = jax.tree.map(jnp.asarray, _tree(0))
    tparams = _torch(_tree(0))
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    assert tstate.step.dtype == torch.int32 and tstate.step.shape == ()
    lr_j, lr_t = jcosine(1e-2, 2, 5), cosine_with_warmup(1e-2, 2, 5)
    for step in range(5):
        grads = _tree(10 + step, scale=0.1 + step)
        lr = lr_j(jstate.step)
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams, lr)
        jparams = jopt.apply(jparams, jupd)
        tupd, tstate = topt.update(_torch(grads), tstate, tparams, lr_t(tstate.step))
        tparams = topt.apply(tparams, tupd)
        assert int(tstate.step) == int(jstate.step) == step + 1
        _close(tupd, jupd)
        _close(tstate.mu, jstate.mu)
        _close(tstate.nu, jstate.nu)
        _close(tparams, jparams)


def test_adamw_updates_in_place():
    """The moments, the step and the params keep their storage (the
    reference's donated buffers); the grads' storage holds the updates."""
    opt = AdamW()
    params = _torch(_tree(0))
    state = opt.init(params)
    grads = _torch(_tree(1))
    ptrs = [t.data_ptr() for t in (params["embed"], state.mu["embed"], state.nu["embed"],
                                   state.step, grads["embed"])]
    upd, state2 = opt.update(grads, state, params, 1e-3)
    new = opt.apply(params, upd)
    assert state2 is state and new is params and upd is grads
    assert ptrs == [t.data_ptr() for t in (new["embed"], state2.mu["embed"],
                                           state2.nu["embed"], state2.step, upd["embed"])]


def test_adamw_first_step_is_sign_of_grad():
    """The reference's hand-computed step: at step 1, mhat = g and vhat = g^2,
    so the update is -lr * sign(g)."""
    opt = AdamW(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    updates, _ = opt.update({"w": torch.tensor([0.1, -0.2, 0.3])}, opt.init(params), params,
                            lr=0.01)
    np.testing.assert_allclose(updates["w"].numpy(), -0.01 * np.sign([0.1, -0.2, 0.3]),
                               rtol=1e-4)
    np.testing.assert_allclose(opt.apply(params, updates)["w"].numpy(), [0.99, -1.99, 2.99],
                               rtol=1e-5)


def test_adamw_weight_decay_direction():
    opt = AdamW(weight_decay=0.1)
    params = {"w": torch.tensor([10.0])}
    updates, _ = opt.update({"w": torch.tensor([0.0])}, opt.init(params), params, lr=0.1)
    assert float(updates["w"][0]) < 0  # decays toward zero


# ---------------------------------------------------------------------------
# clip and schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(3)
    jg, jn = jclip(jax.tree.map(jnp.asarray, grads), max_norm)
    tg, tn = clip_by_global_norm(_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    _close(tg, jg)
    np.testing.assert_allclose(float(global_norm(tg)), min(max_norm, float(jn)), rtol=1e-5)


def test_clip_hand_values():
    clipped, norm = clip_by_global_norm({"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}, 1.0)
    assert float(norm) == pytest.approx(5.0, rel=1e-6)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    same, _ = clip_by_global_norm({"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}, 100.0)
    assert float(same["a"][0]) == 3.0


@pytest.mark.parametrize("warmup,total,min_frac", [(10, 100, 0.1), (0, 7, 0.0), (5, 5, 0.3)])
def test_cosine_with_warmup_matches_reference(warmup, total, min_frac):
    jlr, tlr = jcosine(3e-3, warmup, total, min_frac), cosine_with_warmup(3e-3, warmup, total,
                                                                          min_frac)
    for step in range(total + 3):
        t = tlr(torch.tensor(step, dtype=torch.int32))
        assert t.dtype == torch.float32 and t.shape == ()
        np.testing.assert_allclose(float(t), float(jlr(jnp.int32(step))), **TOL)
    assert float(tlr(0)) == (0.0 if warmup else float(jlr(0)))  # step 0 of a warmup: lr 0


def test_constant_schedule_matches_reference():
    t = constant(2.5e-4)(torch.tensor(7, dtype=torch.int32))
    assert t.dtype == torch.float32 and float(t) == float(jconstant(2.5e-4)(7))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed", [(1000, 16, 4, 3), (256, 33, 2, 0),
                                                  (50304, 128, 3, 11)])
def test_synthetic_lm_is_bit_equal_to_reference(vocab, seq, batch, seed):
    got, want = SyntheticLM(vocab, seq, batch, seed=seed), JSynth(vocab, seq, batch, seed=seed)
    for step in (0, 1, 7, 123457):
        g, w = got.batch_at(step), want.batch_at(step)
        assert set(g) == set(w) == {"tokens", "targets"}
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(zipf_tokens((5, 9), vocab, seed), jzipf((5, 9), vocab, seed))


def test_synthetic_data_deterministic_and_in_range():
    src = SyntheticLM(vocab_size=1000, seq_len=16, global_batch=4, seed=3)
    np.testing.assert_array_equal(src.batch_at(7)["tokens"], src.batch_at(7)["tokens"])
    assert not np.array_equal(src.batch_at(7)["tokens"], src.batch_at(8)["tokens"])
    b = src.batch_at(7)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 1000


@pytest.mark.parametrize("prefetch", [0, 2])
def test_pipeline_order_seek_and_placement(prefetch):
    """The same (step, batch) sequence as the reference's pipeline, before
    and after a seek; with a device, each batch is a tensor there."""
    src = SyntheticLM(vocab_size=100, seq_len=8, global_batch=2, seed=0)
    pipe = DataPipeline(src.batch_at, device="cpu", prefetch=prefetch)
    ref = JPipeline(src.batch_at, prefetch=prefetch)
    try:
        for _ in range(3):
            (s, b), (rs, rb) = next(pipe), next(ref)
            assert s == rs and isinstance(b["tokens"], torch.Tensor)
            np.testing.assert_array_equal(b["tokens"].numpy(), rb["tokens"])
        pipe.seek(10)
        ref.seek(10)
        (s, b), (rs, rb) = next(pipe), next(ref)
        assert s == rs == 10
        np.testing.assert_array_equal(b["targets"].numpy(), src.batch_at(10)["targets"])
        assert next(pipe)[0] == 11
    finally:
        pipe.close()
        ref.close()


def test_pipeline_without_device_hands_numpy_and_no_prefetch_runs_no_thread():
    src = SyntheticLM(vocab_size=100, seq_len=8, global_batch=2, seed=0)
    before = threading.active_count()
    pipe = DataPipeline(src.batch_at, prefetch=0)
    assert threading.active_count() == before
    assert next(pipe)[0] == 0
    step, batch = next(pipe)
    assert step == 1 and isinstance(batch["tokens"], np.ndarray)
    pipe.close()


def test_pipeline_raises_the_producer_error():
    def bad(step):
        if step == 1:
            raise KeyError("no batch 1")
        return {"tokens": np.zeros((1, 2), np.int32)}

    pipe = DataPipeline(bad, device="cpu", prefetch=2)
    try:
        assert next(pipe)[0] == 0
        with pytest.raises(KeyError, match="no batch 1"):
            next(pipe)
    finally:
        pipe.close()
