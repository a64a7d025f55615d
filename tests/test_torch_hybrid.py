"""The port's Zamba2 hybrid LM against the reference on the CPU.

zamba2-7b reduced (one super-unit of 4 Mamba2 layers and a tail of 1, two
shared-attention calls, hd 16, SSM heads of 16, state 16, chunk 16).  The
reference's own ``zamba_init`` weights, with the norm scales, D, dt_bias and
A_log perturbed so that they count, are carried across by
``params_from_jax``; the same numpy tokens go through ``repro.models``
(Pallas kernels in interpret mode where ``ssm_impl``/``attn_impl`` is
``"pallas"``, as the reference's tests run them) and ``repro_torch.models``
(whose kernel wrappers take their plain versions on CPU tensors).  The
prompt of 40 tokens is a multiple of neither the SSD chunk (16) nor the
attention chunk (32), so both kernels' padding runs.  Tolerances: float32
logits, loss and cache leaves at rtol = atol = 1e-4; greedy tokens identical.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import mamba as jmamba
from repro_torch import configs as tconfigs
from repro_torch.models import build_model
from repro_torch.models import common as tcommon
from repro_torch.models import mamba as tmamba
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
IMPLS = [("pallas", "pallas"), ("pallas", "blockwise"), ("xla", "pallas"), ("xla", "blockwise")]
PROMPT, NEW = 40, 8
CACHE_KEYS = ("k", "v", "ssm", "conv", "x0")


def _cfgs(ssm_impl, attn_impl):
    return tuple(m.get_config("zamba2-7b").reduced().replace(ssm_impl=ssm_impl, attn_impl=attn_impl)
                 for m in (jconfigs, tconfigs))


@lru_cache(maxsize=None)
def _jax_params():
    jcfg = jconfigs.get_config("zamba2-7b").reduced()
    p = jax.tree.map(np.asarray, jmamba.zamba_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)

    def perturb(a, scale, base=None):
        base = a if base is None else base
        return (base + scale * rng.normal(size=a.shape)).astype(np.float32)

    for stack in (p["supers"], p["tail"]):
        for name in ("D", "dt_bias", "A_log"):
            stack[name] = perturb(stack[name], 0.3)
        for norm in (stack["norm"], stack["out_norm"]):
            norm["scale"] = perturb(norm["scale"], 0.1, 1.0)
    for norm in (p["shared_attn"]["norm"], p["shared_attn"]["mlp_norm"], p["final_norm"]):
        norm["scale"] = perturb(norm["scale"], 0.1, 1.0)
    return p


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("ssm_impl,attn_impl", IMPLS)
def test_forward_and_loss_parity(ssm_impl, attn_impl):
    jcfg, tcfg = _cfgs(ssm_impl, attn_impl)
    jp = _jax_params()
    tp = params_from_jax(jp, tcfg, device="cpu")
    toks = _tokens((2, PROMPT), 11)
    want = jax.jit(lambda p, t: jmamba.zamba_forward(p, t, jcfg))(jp, toks)
    got = tmamba.zamba_forward(tp, torch.from_numpy(toks), tcfg)
    assert got.shape == (2, PROMPT, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    batch = {"tokens": toks, "targets": _tokens((2, PROMPT), 12)}
    want_loss = jax.jit(japi.build_model(jcfg).loss_fn)(jp, batch)
    got_loss = build_model(tcfg, device="cpu").loss_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)


@pytest.mark.parametrize("ssm_impl,attn_impl", IMPLS)
def test_prefill_and_greedy_decode_parity(ssm_impl, attn_impl):
    jcfg, tcfg = _cfgs(ssm_impl, attn_impl)
    jp = _jax_params()
    jmodel, tmodel = japi.build_model(jcfg), build_model(tcfg, device="cpu")
    tp = params_from_jax(jp, tcfg, device="cpu")
    toks = _tokens((2, PROMPT), 13)
    max_len = PROMPT + NEW

    jlast, jcache = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, max_len))(jp, toks)
    tlast, tcache = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    assert set(tcache) == set(jcache) == set(CACHE_KEYS)
    for key in CACHE_KEYS:
        assert tcache[key].shape == jcache[key].shape
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)

    jstep = jax.jit(jmodel.decode_step)
    jtok, ttok = jnp.argmax(jlast, -1), tlast.argmax(-1)
    jseq, tseq = [], []
    for i in range(NEW):
        pos = np.full((2,), PROMPT + i, np.int32)
        jlog, jcache = jstep(jp, jcache, jtok.astype(jnp.int32), pos)
        tlog, tcache = tmodel.decode_step(tp, tcache, ttok, torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        jtok, ttok = jnp.argmax(jlog, -1), tlog.argmax(-1)
        jseq.append(np.asarray(jtok))
        tseq.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tseq), np.stack(jseq))
    for key in CACHE_KEYS:
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)


@pytest.mark.parametrize("ssm_impl,attn_impl", [("pallas", "pallas"), ("xla", "blockwise")])
def test_prefill_then_decode_matches_forward(ssm_impl, attn_impl):
    """The port alone, as tests/test_decode_consistency.py holds the
    reference: prefill of all but the last token, then one decode step of
    it, continue the full forward."""
    _, tcfg = _cfgs(ssm_impl, attn_impl)
    model = build_model(tcfg, device="cpu")
    tp = params_from_jax(_jax_params(), tcfg, device="cpu")
    toks = torch.from_numpy(_tokens((2, 32), 14))
    full = tmamba.zamba_forward(tp, toks, tcfg)
    last, cache = model.prefill(tp, {"tokens": toks[:, :-1]}, 40)
    torch.testing.assert_close(last, full[:, -2], **TOL)
    logits, _ = model.decode_step(tp, cache, toks[:, -1], torch.full((2,), 31, dtype=torch.int32))
    torch.testing.assert_close(logits, full[:, -1], **TOL)


def test_params_from_jax_matches_zamba_init():
    tcfg = tconfigs.get_config("zamba2-7b").reduced()
    conv = params_from_jax(_jax_params(), tcfg, device="cpu")
    fresh = tmamba.zamba_init(torch.Generator().manual_seed(0), tcfg)
    shapes = lambda t: tcommon.tree_map(lambda a: (tuple(a.shape), a.dtype), t)
    assert shapes(conv) == shapes(fresh)
    assert conv["supers"]["w_in"].shape[:2] == (1, 4) and conv["tail"]["w_in"].shape[0] == 1
    # the reference's analytic param_count() is approximate for the hybrid
    # family; the trees it initialises are what must agree
    assert tcommon.count_params(fresh) == sum(a.size for a in jax.tree.leaves(_jax_params()))
    bad = dict(_jax_params())
    bad.pop("tail")
    with pytest.raises(ValueError, match="expected"):
        params_from_jax(bad, tcfg, device="cpu")
    bad = dict(_jax_params(), tail=jax.tree.map(lambda a: a[:0], _jax_params()["tail"]))
    with pytest.raises(ValueError, match="leading axes"):
        params_from_jax(bad, tcfg, device="cpu")


def test_hybrid_model_api_surface():
    tcfg = tconfigs.get_config("zamba2-7b").reduced()
    model = build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    cache, specs = model.init_cache(2, 16), model.cache_specs(2, 16)
    jspecs = japi.build_model(jconfigs.get_config("zamba2-7b").reduced()).cache_specs(2, 16)
    for key in CACHE_KEYS:
        assert tuple(cache[key].shape) == tuple(specs[key].shape) == jspecs[key].shape
        assert specs[key].device.type == "meta" and cache[key].device.type == "cpu"
    assert cache["ssm"].dtype == torch.float32
    toks = torch.from_numpy(_tokens((2, 6), 3))
    last, _ = model.prefill(params, {"tokens": toks}, 16)
    assert last.shape == (2, tcfg.padded_vocab) and torch.isfinite(last).all()
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill(params, {"tokens": toks}, 4)
    with pytest.raises(ValueError, match="generator"):
        build_model(tcfg, device="meta").init(torch.Generator())
