"""The port's dense LM against the reference on the CPU.

The same numpy inputs, and the reference's own ``lm_init`` weights carried
across by ``params_from_jax``, go through ``repro.models`` (JAX, the Pallas
flash kernel in interpret mode for ``attn_impl="pallas"``, as the reference's
tests run it) and through ``repro_torch.models`` (whose kernel wrappers take
their plain versions on CPU tensors).  Tolerances: float32 logits and caches
at rtol = atol = 1e-4; greedy tokens identical.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import guard
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_jax

# fp32 parity at the reference's own tolerance for the card (256 ulps: 3.05e-5)
_F32_TOL = guard.tolerance(np.float32, "nvidia-h100-sxm")
TOL = dict(rtol=_F32_TOL.rtol, atol=_F32_TOL.atol)
ARCHS = ("gemma-2b", "qwen2.5-14b")  # MQA/geglu/tied/sqrt-d; GQA/qkv bias/swiglu/theta 1e6
IMPLS = ("pallas", "blockwise")
PROMPT, NEW = 40, 8  # 40 is not a multiple of the reduced configs' attn_chunk of 32


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _cfgs(name, impl):
    return (jconfigs.get_config(name).reduced().replace(attn_impl=impl),
            tconfigs.get_config(name).reduced().replace(attn_impl=impl))


@lru_cache(maxsize=None)
def _jax_params(name):
    """The reference's init as numpy, with the norm scales and qkv biases
    (ones and zeros at init) perturbed so the parity covers them."""
    jcfg = jconfigs.get_config(name).reduced()
    p = jax.tree.map(np.asarray, jtr.lm_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    for tree in (p["layers"]["attn_norm"], p["layers"]["mlp_norm"], p["final_norm"]):
        tree["scale"] = (1.0 + 0.1 * rng.normal(size=tree["scale"].shape)).astype(np.float32)
    for b in ("bq", "bk", "bv"):
        if b in p["layers"]["attn"]:
            a = p["layers"]["attn"][b]
            p["layers"]["attn"][b] = (0.1 * rng.normal(size=a.shape)).astype(np.float32)
    return p


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(jconfigs.CONFIGS))
def test_config_fields_match(name):
    jc, tc = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    assert (tc.padded_vocab, tc.param_count(), tc.max_useful_tp()) == (
        jc.padded_vocab, jc.param_count(), jc.max_useful_tp())


def test_config_registry_matches():
    assert tconfigs.list_configs() == jconfigs.list_configs()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("nope")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rmsnorm_parity():
    x, scale = _np((3, 5, 64), 1), 1.0 + _np((64,), 2, 0.1)
    want = jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    got = tcommon.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xb = torch.from_numpy(x).bfloat16()
    assert tcommon.rmsnorm({"scale": torch.from_numpy(scale)}, xb).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_parity(theta):
    x = _np((2, 7, 3, 16), 3)
    pos = np.arange(7, dtype=np.int32)[None].repeat(2, 0) + np.array([[0], [5]], np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_mlp_parity(variant):
    jcfg = jconfigs.get_config("gemma-2b").reduced().replace(mlp_variant=variant)
    jp = jax.tree.map(np.asarray, jmlp.mlp_init(jax.random.PRNGKey(3), jcfg))
    x = _np((2, 5, jcfg.d_model), 4)
    want = jmlp.mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg)
    got = tmlp.mlp({k: torch.tensor(v) for k, v in jp.items()}, torch.from_numpy(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(tmlp.mlp_init(torch.Generator().manual_seed(0), jcfg)) == set(jp)


def test_decode_attention_parity():
    jcfg = jconfigs.get_config("qwen2.5-14b").reduced()
    jp = jax.tree.map(np.asarray, jattn.attn_init(jax.random.PRNGKey(5), jcfg))
    b, smax = 2, 12
    x = _np((b, jcfg.d_model), 6)
    ck = _np((b, smax, jcfg.n_kv_heads, jcfg.head_dim), 7)
    cv = _np((b, smax, jcfg.n_kv_heads, jcfg.head_dim), 8)
    pos = np.array([3, 11], np.int32)
    want = jattn.decode_attention(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg,
                                  jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos))
    tck, tcv = torch.from_numpy(ck), torch.from_numpy(cv)
    got = tattn.decode_attention({k: torch.tensor(v) for k, v in jp.items()},
                                 torch.from_numpy(x), jcfg, tck, tcv, torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(tck.numpy(), ck)  # the caller's cache is left as it was


# ---------------------------------------------------------------------------
# the model, end to end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ARCHS)
def test_lm_forward_parity(name, impl):
    jcfg, tcfg = _cfgs(name, impl)
    jp = _jax_params(name)
    toks = _tokens(jcfg, (2, PROMPT), 11)
    want, _ = jax.jit(lambda p, t: jtr.lm_forward(p, t, jcfg))(jp, toks)
    tp = params_from_jax(jp, tcfg, device="cpu")
    got, aux = ttr.lm_forward(tp, torch.from_numpy(toks), tcfg)
    assert got.shape == (2, PROMPT, tcfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    batch = {"tokens": toks, "targets": _tokens(jcfg, (2, PROMPT), 12)}
    want_loss = jtr.lm_loss(jp, batch, jcfg)
    got_loss = build_model(tcfg, device="cpu").loss_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_greedy_decode_parity(name, impl):
    jcfg, tcfg = _cfgs(name, impl)
    jp = _jax_params(name)
    model = build_model(tcfg, device="cpu")
    tp = params_from_jax(jp, tcfg, device="cpu")
    toks = _tokens(jcfg, (2, PROMPT), 13)
    max_len = PROMPT + NEW

    jlast, jcache = jax.jit(lambda p, t: jtr.lm_prefill(p, t, jcfg, max_len))(jp, toks)
    tlast, tcache = model.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    for key in ("k", "v"):
        assert tcache[key].shape == jcache[key].shape
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)

    jstep = jax.jit(lambda p, c, t, pos: jtr.lm_decode_step(p, c, t, pos, jcfg))
    jtok, ttok = jnp.argmax(jlast, -1), tlast.argmax(-1)
    jseq, tseq = [], []
    for i in range(NEW):
        pos = np.full((2,), PROMPT + i, np.int32)
        jlog, jcache = jstep(jp, jcache, jtok.astype(jnp.int32), pos)
        tlog, tcache = model.decode_step(tp, tcache, ttok, torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        jtok, ttok = jnp.argmax(jlog, -1), tlog.argmax(-1)
        jseq.append(np.asarray(jtok))
        tseq.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tseq), np.stack(jseq))
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)


def test_params_from_jax_matches_lm_init():
    tcfg = tconfigs.get_config("qwen2.5-14b").reduced()
    conv = params_from_jax(_jax_params("qwen2.5-14b"), tcfg, device="cpu")
    fresh = ttr.lm_init(torch.Generator().manual_seed(0), tcfg)
    shapes = lambda t: tcommon.tree_map(lambda a: (tuple(a.shape), a.dtype), t)
    assert shapes(conv) == shapes(fresh)
    assert tcommon.count_params(fresh) == tcfg.param_count()  # vocab 256 needs no padding
    with pytest.raises(ValueError, match="expected"):
        params_from_jax({"embed": np.zeros((4, 4), np.float32)}, tcfg, device="cpu")


def test_init_draws_the_reference_distribution():
    gen = torch.Generator().manual_seed(0)
    w = tcommon.dense_init(gen, (256, 512))
    assert float(w.abs().max()) <= 3.0 / 16 + 1e-6  # truncated at 3 std, std 1/sqrt(256)
    ref = np.asarray(jcommon.dense_init(jax.random.PRNGKey(0), (256, 512)))
    np.testing.assert_allclose(float(w.std()), float(ref.std()), rtol=0.02)
    np.testing.assert_allclose(float(w.abs().mean()), float(np.abs(ref).mean()), rtol=0.02)
    again = tcommon.dense_init(torch.Generator().manual_seed(0), (256, 512))
    assert torch.equal(w, again)


def test_model_api_surface():
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    model = build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    cache = model.init_cache(2, 16)
    specs = model.cache_specs(2, 16)
    assert cache["k"].shape == specs["k"].shape == (tcfg.n_layers, 2, 16, 1, tcfg.head_dim)
    assert specs["k"].device.type == "meta" and cache["k"].device.type == "cpu"
    assert None not in (model.decode_chunk, model.init_paged_cache, model.paged_cache_specs,
                        model.decode_step_paged, model.decode_chunk_paged)
    pool = model.paged_cache_specs(5, 4)
    assert pool["v"].shape == (tcfg.n_layers, 5, 4, 1, tcfg.head_dim)
    assert pool["v"].device.type == "meta"
    hybrid = build_model(tconfigs.get_config("zamba2-7b").reduced(), device="cpu")
    assert hybrid.decode_chunk is None and hybrid.decode_step_paged is None
    toks = torch.from_numpy(_tokens(tcfg, (2, 6), 3))
    last, cache = model.prefill(params, {"tokens": toks}, 16)
    assert last.shape == (2, tcfg.padded_vocab) and torch.isfinite(last).all()
    with pytest.raises(ValueError, match="generator"):
        build_model(tcfg, device="meta").init(torch.Generator())
    for name in ("olmoe-1b-7b", "whisper-base", "internvl2-76b", "xlstm-1.3b"):
        fam = tconfigs.get_config(name).family
        with pytest.raises(NotImplementedError, match=fam):
            build_model(tconfigs.get_config(name), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmlp.moe_block(None, None, None)
