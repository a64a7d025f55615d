"""Shared parts of the tensor-parallel family tests (``test_torch_tp_*``):
the inputs, the reference's unsharded results, and the comparisons.

Each family's ``reduced()`` config runs from the reference's own init
weights, with every leaf that starts constant (zero biases, unit norm
scales, ``D``, ``dt_bias``, ``A_log``, ``conv_b``) perturbed, so that a rank
reading the wrong heads' part of a whole leaf changes the result.  The port
runs on ``model`` meshes of gloo CPU ranks (``torch_dist_workers.tp_family``);
the reference computes the same function on one device, its Pallas paths
in interpret mode as its own tests run them.  Tolerance:
``repro.kernels.guard.tolerance(float32, "nvidia-h100-sxm")`` (256 ulps),
relative to each tensor's largest magnitude for the recurrent state and the
grads, whose entries span decades; greedy tokens identical.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.kernels import guard
from repro.models import build_model as jbuild
from repro.models import encdec as jencdec
from repro.models import mamba as jmamba
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm

_F32 = guard.tolerance(np.float32, "nvidia-h100-sxm")
TOL = dict(rtol=_F32.rtol, atol=_F32.atol)
STEPS = 8  # greedy decode steps after the prefill


def jcfg(name, kw):
    return jconfigs.get_config(name).reduced().replace(**dict(kw))


@lru_cache(maxsize=None)
def np_params(name, kw=()):
    """The reference's init weights as numpy, constant leaves perturbed."""
    cfg = jcfg(name, kw)
    tree = jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.key(0)))
    rng = np.random.default_rng(7)

    def perturb(a):
        if a.size > 1 and np.all(a == a.flat[0]):
            return (a + 0.2 * rng.normal(size=a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(perturb, tree)


@lru_cache(maxsize=None)
def batch(name, kw=(), b=2, s=24, seed=0):
    """Tokens, targets and, for the encoder-decoder and the VLM, frontend
    embeddings (B, frontend_len, d)."""
    cfg = jcfg(name, kw)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family in ("encdec", "vlm"):
        out["frontend"] = rng.normal(size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def _forward(cfg, p, bt):
    if cfg.family == "hybrid":
        return jmamba.zamba_forward(p, bt["tokens"], cfg)
    if cfg.family == "ssm":
        return jxlstm.xlstm_forward(p, bt["tokens"], cfg)
    if cfg.family == "encdec":
        return jencdec.decode_train(p, bt["tokens"], jencdec.encode(p, bt["frontend"], cfg), cfg)
    return jtransformer.lm_forward(p, bt["tokens"], cfg, bt.get("frontend"))[0]


@lru_cache(maxsize=None)
def reference(name, kw=(), s=24, steps=STEPS, grads=True):
    """The reference's forward logits, loss and grads, prefill (last logits
    and cache), and ``steps`` greedy decode steps (logits, tokens, final
    cache), on one device."""
    cfg = jcfg(name, kw)
    model = jbuild(cfg)
    p = jax.tree.map(jnp.asarray, np_params(name, kw))
    bt = {k: jnp.asarray(v) for k, v in batch(name, kw, s=s).items()}
    out = {"logits": np.asarray(jax.jit(lambda p, b: _forward(cfg, p, b))(p, bt))}
    if grads:
        loss, g = jax.jit(jax.value_and_grad(model.loss_fn))(p, bt)
        out.update(loss=float(loss), grads=jax.tree.map(np.asarray, g))
    feed = {k: v for k, v in bt.items() if k != "targets"}
    plen = s + (cfg.frontend_len if cfg.family == "vlm" else 0)
    last, cache = jax.jit(lambda p, f: model.prefill(p, f, plen + steps))(p, feed)
    out.update(prefill_last=np.asarray(last), prefill_cache=jax.tree.map(np.asarray, cache))
    step = jax.jit(model.decode_step)
    tok, rows, toks = jnp.argmax(last, -1), [], []
    for i in range(steps):
        pos = jnp.full((tok.shape[0],), plen + i, jnp.int32)
        logits, cache = step(p, cache, tok.astype(jnp.int32), pos)
        tok = jnp.argmax(logits, -1)
        rows.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    out.update(step_logits=np.stack(rows), tokens=np.stack(toks),
               final_cache=jax.tree.map(np.asarray, cache))
    return out


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def close_scaled(got, want, what):
    """Within the tolerance relative to the largest magnitude of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, err_msg=what, **TOL)


def check_rank(got, want, what, grads=True):
    """One rank's results (``torch_dist_workers.tp_family``) against the
    reference's: logits, loss, this rank's slice of every grad, the prefill
    and its cache, the decode steps' logits and tokens and the last cache."""
    np.testing.assert_allclose(got["logits"], want["logits"], err_msg=f"{what} logits", **TOL)
    if grads:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=what)
        for (path, g), (_, sl), (_, w) in zip(leaves(got["grads"]), leaves(got["slices"]),
                                             leaves(want["grads"])):
            close_scaled(g, w[tuple(slice(a, b) for a, b in sl)], f"{what} grad {path}")
    np.testing.assert_allclose(got["prefill_last"], want["prefill_last"],
                               err_msg=f"{what} prefill", **TOL)
    for key in ("prefill_cache", "final_cache"):
        assert set(got[key]) == set(want[key]), (what, key)
        for leaf in want[key]:
            close_scaled(got[key][leaf], want[key][leaf], f"{what} {key} {leaf}")
    np.testing.assert_allclose(got["step_logits"], want["step_logits"],
                               err_msg=f"{what} decode", **TOL)
    np.testing.assert_array_equal(got["tokens"], want["tokens"], err_msg=f"{what} tokens")
