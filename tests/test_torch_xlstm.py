"""The port's xLSTM family against the reference on the CPU.

The same numpy inputs, and the reference's own ``xlstm_init`` weights carried
across by ``params_from_jax``, go through ``repro.models.xlstm`` (JAX) and
``repro_torch.models.xlstm``: the mLSTM cell (chunkwise and stepwise), the
sLSTM scan, forward, loss, prefill (every cache leaf) and greedy decode.
Tolerances: ``repro.kernels.guard.tolerance(float32, "nvidia-h100-sxm")``
(256 ulps), relative to each output's largest magnitude for the recurrent
states (their entries span decades), greedy tokens identical; within the
port, the chunkwise mLSTM equals the stepwise recurrence and prefill then
decode equals the forward within the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import guard
from repro.models import build_model as jbuild
from repro.models import xlstm as jx
from repro_torch import configs as tconfigs
from repro_torch.models import build_model
from repro_torch.models import xlstm as tx
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_jax

_TOL = guard.tolerance(np.float32, "nvidia-h100-sxm")
TOL = dict(rtol=_TOL.rtol, atol=_TOL.atol)
NAME = "xlstm-1.3b"
PROMPT, NEW = 40, 8  # 40 is not a multiple of the reduced ssm_chunk of 16


def _cfgs(**kw):
    return (jconfigs.get_config(NAME).reduced().replace(**kw),
            tconfigs.get_config(NAME).reduced().replace(**kw))


def _params():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jx.xlstm_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)  # norm scales off their init of ones
    for tree in (jp["macros"]["mlstm"]["norm"], jp["macros"]["slstm"]["ffn_norm"],
                 jp["final_norm"]):
        tree["scale"] = (1.0 + 0.1 * rng.normal(size=tree["scale"].shape)).astype(np.float32)
    return jp, params_from_jax(jp, tcfg, device="cpu")


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close_scaled(got, want):
    """Within the tolerance relative to the output's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, **TOL)


def _cell_inputs(b=2, s=37, h=4, hd=8, seed=0):
    q, k, v = (_np((b, s, h, hd), seed + i, 0.5) for i in range(3))
    i_raw = _np((b, s, h), seed + 3, 2.0)
    log_f = np.log(1 / (1 + np.exp(-(_np((b, s, h), seed + 4) + 2.0)))).astype(np.float32)
    state = (_np((b, h, hd, hd), seed + 5, 0.1), np.abs(_np((b, h, hd), seed + 6, 0.1)),
             _np((b, h), seed + 7))
    return (q, k, v, i_raw, log_f), state


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunked_matches_reference(chunk):
    ins, state = _cell_inputs()
    jy, jst = jx.mlstm_chunked(*ins, state, chunk)
    ty, tst = tx.mlstm_chunked(*map(_t, ins), tuple(map(_t, state)), chunk)
    _close_scaled(ty.numpy(), jy)
    for a, b in zip(tst, jst):
        _close_scaled(a.numpy(), b)


def test_mlstm_step_matches_reference():
    ins, state = _cell_inputs(s=1)
    ins = [a[:, 0] for a in ins]
    jy, jst = jx.mlstm_step(*ins, state)
    ty, tst = tx.mlstm_step(*map(_t, ins), tuple(map(_t, state)))
    _close_scaled(ty.numpy(), jy)
    for a, b in zip(tst, jst):
        _close_scaled(a.numpy(), b)


def test_mlstm_chunked_equals_the_stepwise_recurrence():
    ins, state = _cell_inputs(s=21)
    y, st = tx.mlstm_chunked(*map(_t, ins), tuple(map(_t, state)), 8)
    carry, rows = tuple(map(_t, state)), []
    for t in range(21):
        yt, carry = tx.mlstm_step(*(_t(a[:, t]) for a in ins), carry)
        rows.append(yt)
    _close_scaled(y.numpy(), torch.stack(rows, 1).numpy())
    for a, b in zip(st, carry):
        _close_scaled(a.numpy(), b.numpy())


def test_slstm_scan_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    sp_j = jax.tree.map(lambda a: a[0], jp["macros"]["slstm"])
    sp_t = {k: v[0] for k, v in tp["macros"]["slstm"].items() if not isinstance(v, dict)}
    d, h = tcfg.d_model, tcfg.n_heads
    xg = _np((2, 19, 4 * d), 3)
    state = tuple(_np((2, h, d // h), 10 + i, 0.3) for i in range(4))
    state = (state[0], np.abs(state[1]) + 0.5, state[2], state[3])
    jy, jst = jx._slstm_scan(sp_j, xg, jcfg, state)
    ty, tst = tx._slstm_scan(sp_t, _t(xg), tcfg, tuple(map(_t, state)))
    _close_scaled(ty.numpy(), jy)
    for a, b in zip(tst, jst):
        _close_scaled(a.numpy(), b)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_loss_match_reference(remat):
    jcfg, tcfg = _cfgs(remat=remat)
    jp, tp = _params()
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    tgts = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jlog = jx.xlstm_forward(jp, toks, jcfg)
    tlog = tx.xlstm_forward(tp, _t(toks), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    batch = {"tokens": toks, "targets": tgts}
    jl = jbuild(jcfg).loss_fn(jp, batch)
    tl = build_model(tcfg, device="cpu").loss_fn(tp, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_prefill_and_greedy_decode_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    jm, tm = jbuild(jcfg), build_model(tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jlast, jcache = jm.prefill(jp, {"tokens": toks})
    tlast, tcache = tm.prefill(tp, {"tokens": _t(toks)}, PROMPT + NEW)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    assert set(tcache) == set(jcache)
    specs = tm.cache_specs(2, PROMPT + NEW)
    for k in jcache:
        assert tcache[k].shape == specs[k].shape == jcache[k].shape
        assert specs[k].device.type == "meta" and tcache[k].dtype == torch.float32
        _close_scaled(tcache[k].numpy(), jcache[k])
    jtok, ttok = np.argmax(np.asarray(jlast), -1), tlast.argmax(-1)
    assert np.array_equal(ttok.numpy(), jtok)
    for i in range(NEW):
        pos = np.full((2,), PROMPT + i, np.int32)
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(jtok, jnp.int32), pos)
        tlog, tcache = tm.decode_step(tp, tcache, ttok, _t(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        jtok, ttok = np.argmax(np.asarray(jlog), -1), tlog.argmax(-1)
        assert np.array_equal(ttok.numpy(), jtok)


def test_prefill_then_decode_equals_the_forward():
    """Teacher forcing: prefill the first P tokens, feed the rest one decode
    step at a time; each step's logits equal the forward's at that position
    (the step recurrence against the chunkwise form)."""
    _, tcfg = _cfgs()
    _, tp = _params()
    model = build_model(tcfg, device="cpu")
    toks = _t(np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, PROMPT)).astype(
        np.int32))
    full = tx.xlstm_forward(tp, toks, tcfg)
    p = 24
    last, cache = model.prefill(tp, {"tokens": toks[:, :p]})
    np.testing.assert_allclose(last.numpy(), full[:, p - 1].numpy(), **TOL)
    before = {k: v.clone() for k, v in cache.items()}
    for t in range(p, PROMPT):
        logits, new = model.decode_step(tp, cache, toks[:, t], torch.full((2,), t))
        assert all(torch.equal(cache[k], before[k]) for k in cache)  # the old one is untouched
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), **TOL)
        cache, before = new, {k: v.clone() for k, v in new.items()}


def test_cache_starts_at_zero_and_bf16_runs():
    jcfg, tcfg = _cfgs()
    model = build_model(tcfg, device="cpu")
    cache = model.init_cache(3, 16)
    assert all(float(v.abs().sum()) == 0 for v in cache.values())
    assert cache["mC"].shape == (2, 1, 3, 4, 16, 16) and cache["sh"].shape == (2, 3, 4, 16)
    bf = build_model(tcfg.replace(dtype="bfloat16"), device="cpu")
    params = bf.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, tcfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    last, cache = bf.prefill(params, {"tokens": toks})
    assert last.dtype == torch.bfloat16 and torch.isfinite(last.float()).all()
    logits, _ = bf.decode_step(params, cache, last.argmax(-1), torch.full((2,), 20))
    assert torch.isfinite(logits.float()).all()


def test_params_from_jax_carries_the_stacks():
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    nm = tx.n_macros(tcfg)
    assert nm == 2 and tp["macros"]["mlstm"]["w_qkv"].shape == (nm, 1, 64, 192)
    assert tp["macros"]["slstm"]["r"].shape == (nm, 4, 4, 16, 16)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), b)
    init = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert [(t.shape, t.dtype) for t in jax.tree.leaves(init)] == [
        (t.shape, t.dtype) for t in jax.tree.leaves(tp)]
    bad = dict(jp, macros={"mlstm": jp["macros"]["mlstm"],
                           "slstm": jax.tree.map(lambda a: a[:1], jp["macros"]["slstm"])})
    with pytest.raises(ValueError, match="macros/slstm"):
        params_from_jax(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="n_layers 5"):
        tx.n_macros(tcfg.replace(n_layers=5))
