"""The port's transformer LM (dense, MoE, VLM) against the reference on the CPU.

The same numpy inputs, and the reference's own ``lm_init`` weights carried
across by ``params_from_jax``, go through ``repro.models`` (JAX, the Pallas
flash kernel in interpret mode for ``attn_impl="pallas"``, as the reference's
tests run it) and through ``repro_torch.models`` (whose kernel wrappers take
their plain versions on CPU tensors).  The VLM gets a seeded frontend of
patch embeddings; the MoE's aux loss is compared too.  Tolerances:
``repro.kernels.guard.tolerance(float32)`` on the card (256 ulps) for
logits, losses and caches; greedy tokens identical.  Both packages'
serving engines also serve olmoe-1b-7b reduced, dense and paged, with
capacity drops in the prefill chunks: every token stream equal.
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
from repro.models import build_model as jbuild
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
# MQA/geglu/tied/sqrt-d; GQA/qkv bias/swiglu/theta 1e6; MoE top-2 of 4; VLM frontend
ARCHS = ("gemma-2b", "qwen2.5-14b", "olmoe-1b-7b", "internvl2-76b")
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


def _frontend(cfg, batch, seed):
    """The VLM's seeded patch embeddings (B, frontend_len, d), else None."""
    if cfg.family != "vlm":
        return None
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)


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
    fe = _frontend(jcfg, 2, 14)
    want, want_aux = jax.jit(lambda p, t, f: jtr.lm_forward(p, t, jcfg, f))(jp, toks, fe)
    tp = params_from_jax(jp, tcfg, device="cpu")
    got, aux = ttr.lm_forward(tp, torch.from_numpy(toks), tcfg,
                              None if fe is None else torch.from_numpy(fe))
    s = PROMPT + (0 if fe is None else jcfg.frontend_len)
    assert got.shape == (2, s, tcfg.padded_vocab)
    assert (float(aux) > 0) == (tcfg.family == "moe")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    batch = {"tokens": toks, "targets": _tokens(jcfg, (2, PROMPT), 12)}
    if fe is not None:
        batch["frontend"] = fe
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
    fe = _frontend(jcfg, 2, 15)
    start = PROMPT + (0 if fe is None else jcfg.frontend_len)
    max_len = start + NEW

    jlast, jcache = jax.jit(lambda p, t, f: jtr.lm_prefill(p, t, jcfg, max_len, frontend=f))(
        jp, toks, fe)
    batch = {"tokens": torch.from_numpy(toks)}
    if fe is not None:
        batch["frontend"] = torch.from_numpy(fe)
    tlast, tcache = model.prefill(tp, batch, max_len)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    for key in ("k", "v"):
        assert tcache[key].shape == jcache[key].shape
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)

    jstep = jax.jit(lambda p, c, t, pos: jtr.lm_decode_step(p, c, t, pos, jcfg))
    jtok, ttok = jnp.argmax(jlast, -1), tlast.argmax(-1)
    jseq, tseq = [], []
    for i in range(NEW):
        pos = np.full((2,), start + i, np.int32)
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
    for name in ("olmoe-1b-7b", "whisper-base", "internvl2-76b", "xlstm-1.3b"):  # ported
        other = build_model(tconfigs.get_config(name).reduced(), device="cpu")
        assert other.cfg.family == tconfigs.get_config(name).family
        assert (other.decode_chunk is None) == (other.cfg.family in ("encdec", "ssm"))
    with pytest.raises(ValueError, match="unknown family"):
        build_model(tcfg.replace(family="rnn"), device="cpu")
    with pytest.raises((TypeError, AttributeError)):  # a real block now, not a stub
        tmlp.moe_block(None, None, None)


# ---------------------------------------------------------------------------
# the xLSTM builds; the serving engine and the cluster refuse it, as the
# reference's do (tests/test_cluster.py's typed family refusal)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def xlstm_model():
    cfg = tconfigs.get_config("xlstm-1.3b").reduced()
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def test_xlstm_builds_with_the_references_surface(xlstm_model):
    cfg, model, params = xlstm_model
    assert model.cfg.family == "ssm" and model.device.type == "cpu"
    assert None is model.decode_chunk is model.init_paged_cache is model.decode_step_paged
    jcfg = jconfigs.get_config("xlstm-1.3b").reduced()
    want = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.key(0)))
    assert [tuple(t.shape) for t in jax.tree.leaves(params)] == [
        tuple(t.shape) for t in jax.tree.leaves(want)]
    toks = torch.from_numpy(_tokens(cfg, (2, 6), 3))
    last, cache = model.prefill(params, {"tokens": toks}, 16)
    assert last.shape == (2, cfg.padded_vocab) and torch.isfinite(last).all()
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in model.cache_specs(2, 16).items()}


def test_engine_refuses_xlstm_with_the_references_error(xlstm_model):
    from repro import serve as jserve
    from repro_torch import serve as tserve

    cfg, model, params = xlstm_model
    for extra in ({}, {"page_size": 4}):
        with pytest.raises(tserve.UnsupportedFamilyError) as exc:
            tserve.ServeEngine(model, params, tserve.EngineConfig(n_slots=2, max_len=16, **extra))
        assert exc.value.family == cfg.family == "ssm"
        assert exc.value.missing == "decode_chunk"
        assert isinstance(exc.value, NotImplementedError)
        assert str(exc.value) == str(jserve.UnsupportedFamilyError("ssm"))


def test_cluster_refuses_xlstm_at_submit(xlstm_model):
    from repro_torch import serve as tserve

    _, model, params = xlstm_model
    cluster = tserve.ClusterRouter(model, params, tserve.ClusterConfig(
        engine=tserve.EngineConfig(n_slots=2, max_len=16), n_replicas=2))
    # construction is lazy: no error until the first submit
    with pytest.raises(tserve.UnsupportedFamilyError, match="decode_chunk"):
        cluster.submit([1, 2, 3], 4)


# ---------------------------------------------------------------------------
# serving a MoE: both packages' engines, capacity drops in the prefill chunks
# ---------------------------------------------------------------------------
def _first_chunk_drops(monkeypatch, model, params, prompts, chunk) -> int:
    """The real assignments the port's ``moe_block`` drops (``moe_drop_count``)
    in each prompt's first prefill chunk: its first ``chunk`` tokens at
    positions 0..chunk-1, one lane each, which is the first group an engine
    prefilling in ``chunk``-token chunks routes for it (the pad entries it
    adds after them route later in the lane and displace none)."""
    counts = []
    block = tmlp.moe_block

    def spy(p, x, cfg, *rest):
        counts.append(int(tmlp.moe_drop_count(p, x, cfg)))
        return block(p, x, cfg, *rest)

    toks = torch.tensor([p[:chunk] for p in prompts], dtype=torch.int32)
    pos = torch.arange(chunk, dtype=torch.int32).expand(len(prompts), -1)
    with monkeypatch.context() as m:
        m.setattr(tmlp, "moe_block", spy)
        model.decode_chunk(params, model.init_cache(len(prompts), chunk), toks, pos)
    assert len(counts) == model.cfg.n_layers
    return sum(counts)


@pytest.mark.parametrize("page_size, mix", [
    (None, "at_once"), (4, "at_once"), (None, "staggered"), (4, "staggered"), (4, "preempt")],
    ids=["None", "4", "None-staggered", "4-staggered", "4-preempt"])
def test_moe_engine_streams_match_reference_with_drops(page_size, mix, monkeypatch):
    """olmoe-1b-7b reduced with one shared direction added to every embedding
    row, so tokens route alike and a prefill chunk of 32 overflows its
    capacity of 24 (a decode step's group of one never does).  Prompts are
    prefilled in the same 32-token chunks by both engines, so the same
    assignments drop, and every stream equals the reference's.  The first
    tick's prompts of 40 and 70 tokens end in chunks 2 and 3, so the paged
    engine's calls shrink from 2 rows to 1, each row its own routing group;
    ``staggered`` submits one prompt a tick, and ``preempt`` runs a pool too
    small for both lanes, so a preempted request resumes on its prompt and
    its output."""
    from repro import serve as jserve
    from repro_torch import serve as tserve

    jcfg = jconfigs.get_config("olmoe-1b-7b").reduced()
    tcfg = tconfigs.get_config("olmoe-1b-7b").reduced()
    jp = dict(_jax_params("olmoe-1b-7b"))
    rng = np.random.default_rng(3)
    jp["embed"] = (jp["embed"] + 0.5 * rng.normal(size=jcfg.d_model)).astype(np.float32)
    tp = params_from_jax(jp, tcfg, device="cpu")
    prompts = [[int(t) for t in rng.integers(1, jcfg.vocab_size, n)] for n in (40, 70, 33, 64)]
    config = dict(n_slots=2, max_len=96, prefill_chunk=32)
    if page_size:
        config.update(page_size=page_size, n_pages=2 * 96 // page_size + 4)
    if mix == "preempt":
        config.update(n_pages=30)
    arrive = 1 if mix == "staggered" else len(prompts)

    def drive(eng):
        ss = []
        while len(ss) < len(prompts) or eng.has_work():
            ss += [eng.submit(p, 6) for p in prompts[len(ss):len(ss) + arrive]]
            eng.step()
            assert eng.tick < 400
        return [s.out for s in ss], eng.summary()["generated_tokens"], eng.summary()["preemptions"]

    want = drive(jserve.ServeEngine(jbuild(jcfg), jax.tree.map(jnp.asarray, jp),
                                    jserve.EngineConfig(**config)))
    model = build_model(tcfg, device="cpu")
    got = drive(tserve.ServeEngine(model, tp, tserve.EngineConfig(**config)))
    assert got == want and got[1] == 6 * len(prompts)
    assert (got[2] > 0) == (mix == "preempt")
    # real tokens' assignments drop in the chunks both engines prefilled
    assert _first_chunk_drops(monkeypatch, model, tp, prompts, config["prefill_chunk"]) > 0
