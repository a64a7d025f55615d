"""The port's paged KV cache and chunked decode against the reference on the
CPU: the host-side allocator, ``gather_pages`` / ``paged_write``, the logits
of ``lm_decode_chunk``, ``lm_decode_chunk_paged`` and ``lm_decode_step_paged``
on gemma-2b reduced (the reference's ``lm_init`` weights carried across by
``params_from_jax``; float32 within ``guard.tolerance(float32,
"nvidia-h100-sxm")``, 3.05e-5), and the engine's paged token streams —
page sizes, pool exhaustion with preemption, shared prefixes with
copy-on-write forks — identical to the reference engine's for the seeded
workloads of ``tests/test_paged_kv.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.kernels import guard as jguard
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax

_F32 = jguard.tolerance(np.float32, "nvidia-h100-sxm")
TOL = dict(rtol=_F32.rtol, atol=_F32.atol)


@pytest.fixture(scope="module")
def gemma():
    """Both packages' gemma-2b reduced models over the reference's init."""
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return (jcfg, jmodel, jparams), (tcfg, tbuild(tcfg, device="cpu"), tparams)


def _prompts(cfg, n, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, lens[i % len(lens)])]
            for i in range(n)]


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int32))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)


# ---------------------------------------------------------------------------
# host-side allocator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_random_walk_matches_reference(seed):
    """The same seeded sequence of alloc/share/free (double frees and
    exhaustion included) gives the same pages and errors from both
    allocators and leaves them in the same state after every operation."""
    rng = np.random.default_rng(seed)
    ja, ta = jserve.PageAllocator(12, 4), tserve.PageAllocator(12, 4)
    owned: list = []  # page lists handed out, shared or freed at random
    for _ in range(300):
        op, n, pick = int(rng.integers(3)), int(rng.integers(1, 5)), int(rng.integers(1 << 30))
        results = []
        for a in (ja, ta):
            try:
                if op == 0:
                    results.append(a.alloc(n))
                elif owned:
                    pages = owned[pick % len(owned)]
                    results.append(a.share(pages) if op == 1 else a.free(pages))
                else:
                    results.append(None)
            except RuntimeError as err:  # PagePoolExhausted
                results.append(("exhausted", str(err)))
            except ValueError as err:  # double free / share of a free page
                results.append(("value", str(err)))
        assert results[0] == results[1]
        if op == 0 and isinstance(results[0], list):
            owned.append(results[0])
        assert (ja.free_pages, ja.used, ja._free, sorted(ja._refs.items())) == (
            ta.free_pages, ta.used, ta._free, sorted(ta._refs.items()))


def test_allocator_contract():
    a = tserve.PageAllocator(n_pages=4, page_size=8)
    p = a.alloc(2)
    assert (a.used, a.free_pages, p) == (2, 2, [0, 1])
    a.share(p)
    assert a.is_shared(p[0]) and a.refcount(p[1]) == 2
    a.free(p)
    assert a.used == 2 and not a.is_shared(p[0])
    a.free(p)
    assert a.used == 0
    with pytest.raises(ValueError, match="double free"):
        a.free(p)
    with pytest.raises(ValueError, match="not allocated"):
        a.share([3])
    with pytest.raises(tserve.PagePoolExhausted, match="need 5 pages, 4 free"):
        a.alloc(5)
    assert a.free_pages == 4  # the failed alloc claimed nothing
    assert [a.pages_for(n) for n in (1, 8, 9, 16, 17)] == [1, 1, 2, 2, 3]
    with pytest.raises(ValueError):
        tserve.PageAllocator(0, 4)


# ---------------------------------------------------------------------------
# gather_pages / paged_write
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_pages_and_paged_write_match_reference(seed):
    """A permuted block table, ragged positions and pad entries (>= T*page):
    the port writes and gathers exactly what the reference's one-hot select
    does, and leaves the pool it was given as it was."""
    rng = np.random.default_rng(seed)
    n, page, t, b, c = 10, 4, 3, 3, 5
    pool = rng.standard_normal((n, page, 2, 3)).astype(np.float32)
    bt = rng.permutation(n)[:b * t].reshape(b, t).astype(np.int32)  # distinct pages
    positions = np.full((b, c), t * page, np.int32)  # lane 1: all pad
    positions[0, :4] = [0, 5, 6, 11]
    positions[2, :2] = [3, 4]
    val = rng.standard_normal((b, c, 2, 3)).astype(np.float32)
    want = np.asarray(jattn.paged_write(jnp.asarray(pool), jnp.asarray(bt),
                                        jnp.asarray(positions), jnp.asarray(val)))
    tpool = torch.from_numpy(pool.copy())
    got = tattn.paged_write(tpool, _i32(bt), _i32(positions), torch.from_numpy(val))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tpool.numpy(), pool)  # functional: the input is untouched
    gathered = tattn.gather_pages(got, _i32(bt))
    assert np.array_equal(gathered.numpy(),
                          np.asarray(jattn.gather_pages(jnp.asarray(want), jnp.asarray(bt))))
    assert gathered.shape == (b, t * page, 2, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_in_place_writes_match_the_functional_ones(seed):
    """``put_kv_`` writes into the tensor it is given, through a plan made
    without reading the pad mask back to the host: the same values as a
    masked loop (dense) and as ``paged_write`` (paged), pad entries and
    all-pad batches writing nothing."""
    rng = np.random.default_rng(seed)
    b, smax, c = 3, 8, 4
    cache = rng.standard_normal((b, smax, 2, 3)).astype(np.float32)
    positions = np.full((b, c), smax, np.int32)
    positions[0, :3] = rng.permutation(smax)[:3]
    positions[2, 1:] = rng.permutation(smax)[:3]  # lane 1: all pad
    val = rng.standard_normal((b, c, 2, 3)).astype(np.float32)
    want = cache.copy()
    for i in range(b):
        for j in range(c):
            if positions[i, j] < smax:
                want[i, positions[i, j]] = val[i, j]
    tcache = torch.from_numpy(cache.copy())
    got = tattn.put_kv_(tcache, tattn.dense_write_plan(smax, _i32(positions)),
                        torch.from_numpy(val))
    assert got is tcache and np.array_equal(got.numpy(), want)
    untouched = tattn.put_kv_(torch.from_numpy(cache.copy()),
                              tattn.dense_write_plan(smax, _i32(np.full((b, c), smax))),
                              torch.from_numpy(val))
    assert np.array_equal(untouched.numpy(), cache)

    n, page, t = 10, 4, 3
    pool = rng.standard_normal((n, page, 2, 3)).astype(np.float32)
    bt = _i32(rng.permutation(n)[:b * t].reshape(b, t))
    ppos = _i32(np.where(positions < smax, positions, t * page))
    tpool = torch.from_numpy(pool.copy())
    got = tattn.put_kv_(tpool, tattn.paged_write_plan(page, bt, ppos), torch.from_numpy(val))
    assert got is tpool
    assert torch.equal(got, tattn.paged_write(torch.from_numpy(pool), bt, ppos,
                                              torch.from_numpy(val)))
    allpad = tattn.put_kv_(torch.from_numpy(pool.copy()),
                           tattn.paged_write_plan(page, bt, _i32(np.full((b, c), t * page))),
                           torch.from_numpy(val))
    assert np.array_equal(allpad.numpy(), pool)


def test_decode_steps_update_the_cache_they_are_given(gemma):
    """The model's decode functions write into the cache passed in and return
    it (the reference's jitted steps donate theirs)."""
    _, (tcfg, tmodel, tparams) = gemma
    bt = _i32([[1, 2], [3, 4]])
    tk, ps = _i32([[5, 6], [7, 8]]), _i32([[0, 1], [0, 8]])
    calls = (
        (tmodel.decode_chunk, tmodel.init_cache(2, 8), (tk, ps)),
        (tmodel.decode_step, tmodel.init_cache(2, 8), (tk[:, 0], ps[:, 0])),
        (tmodel.decode_chunk_paged, tmodel.init_paged_cache(5, 4), (bt, tk, ps)),
        (tmodel.decode_step_paged, tmodel.init_paged_cache(5, 4), (bt, tk[:, 0], ps[:, 0])),
    )
    for fn, cache, args in calls:
        k = cache["k"]
        _, out = fn(tparams, cache, *args)
        assert out["k"] is k and k.abs().sum() > 0


def test_paged_cache_init_and_specs():
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    pool = tattn.init_paged_cache(tcfg, 6, 4, 2, torch.float32, device="cpu")
    specs = tattn.paged_cache_specs(tcfg, 6, 4, 2, torch.float32)
    jspecs = jattn.paged_cache_specs(jcfg, 6, 4, 2, jnp.float32)
    for k in ("k", "v"):
        assert pool[k].shape == specs[k].shape == jspecs[k].shape
        assert specs[k].device.type == "meta" and not pool[k].any()


# ---------------------------------------------------------------------------
# model level: chunked and paged decode logits against the reference
# ---------------------------------------------------------------------------
def _ragged(cfg, lens, width, pad, seed):
    toks = _prompts(cfg, len(lens), lens, seed)
    tk = np.zeros((len(lens), width), np.int32)
    ps = np.full((len(lens), width), pad, np.int32)
    for i, p in enumerate(toks):
        tk[i, :len(p)] = p
        ps[i, :len(p)] = np.arange(len(p))
    return tk, ps


def test_decode_chunk_logits_match_reference(gemma):
    """Two chunks over ragged lanes (one lane all pad in the second chunk):
    logits of every real entry and the caches within tolerance."""
    (jcfg, _, jparams), (tcfg, tmodel, tparams) = gemma
    max_len, chunk = 16, 4
    tk, ps = _ragged(jcfg, [7, 3, 6], 2 * chunk, max_len, seed=3)
    jcache = jattn.init_cache(jcfg, 3, max_len, jcfg.n_layers, jnp.float32)
    tcache = tmodel.init_cache(3, max_len)
    for c in range(2):
        sl = slice(c * chunk, (c + 1) * chunk)
        want, jcache = jtr.lm_decode_chunk(jparams, jcache, jnp.asarray(tk[:, sl]),
                                           jnp.asarray(ps[:, sl]), jcfg)
        got, tcache = tmodel.decode_chunk(tparams, tcache, _i32(tk[:, sl]), _i32(ps[:, sl]))
        real = ps[:, sl] < max_len
        _close(got[torch.from_numpy(real)], np.asarray(want)[real])
        for k in ("k", "v"):
            _close(tcache[k], jcache[k])


def test_decode_chunk_paged_logits_match_reference(gemma):
    (jcfg, _, jparams), (tcfg, tmodel, tparams) = gemma
    page, t = 4, 3
    bt = np.array([[5, 2, 7], [1, 6, 3]], np.int32)
    tk, ps = _ragged(jcfg, [9, 5], 9, t * page, seed=4)
    jpool = jattn.init_paged_cache(jcfg, 8, page, jcfg.n_layers, jnp.float32)
    tpool = tmodel.init_paged_cache(8, page)
    want, jpool = jtr.lm_decode_chunk_paged(jparams, jpool, jnp.asarray(bt), jnp.asarray(tk),
                                            jnp.asarray(ps), jcfg)
    got, tpool = tmodel.decode_chunk_paged(tparams, tpool, _i32(bt), _i32(tk), _i32(ps))
    real = ps < t * page
    _close(got[torch.from_numpy(real)], np.asarray(want)[real])
    for k in ("k", "v"):
        _close(tpool[k], jpool[k])


def test_decode_step_paged_logits_match_reference(gemma):
    """Token-by-token decode through a permuted page table, lanes of unequal
    length (the shorter one pads out): every real logits row within
    tolerance of the reference's, and greedy tokens identical."""
    (jcfg, _, jparams), (tcfg, tmodel, tparams) = gemma
    page, t = 4, 3
    bt = np.array([[5, 2, 7], [1, 6, 3]], np.int32)
    lens = [7, 5]
    toks = _prompts(jcfg, 2, lens, seed=1)
    jpool = jattn.init_paged_cache(jcfg, 8, page, jcfg.n_layers, jnp.float32)
    tpool = tmodel.init_paged_cache(8, page)
    jstep = jax.jit(lambda p, c, b, x, q: jtr.lm_decode_step_paged(p, c, b, x, q, jcfg))
    for i in range(max(lens)):
        tk = np.array([p[i] if i < len(p) else 0 for p in toks], np.int32)
        pos = np.array([i if i < len(p) else t * page for p in toks], np.int32)
        want, jpool = jstep(jparams, jpool, jnp.asarray(bt), jnp.asarray(tk), jnp.asarray(pos))
        got, tpool = tmodel.decode_step_paged(tparams, tpool, _i32(bt), _i32(tk), _i32(pos))
        for b in range(2):
            if i < lens[b]:
                _close(got[b], want[b])
                assert int(got[b].argmax()) == int(jnp.argmax(want[b]))


def test_paged_decode_equals_dense_bit_for_bit_when_the_table_spans_max_len(gemma):
    """With T*page == max_len the gathered view has the dense cache's length,
    so the paged path computes exactly the dense path's numbers."""
    _, (tcfg, tmodel, tparams) = gemma
    page, t = 4, 3
    max_len = t * page
    bt = _i32([[5, 2, 7], [1, 6, 3]])
    lens = [7, 5]
    toks = _prompts(tcfg, 2, lens, seed=1)
    dense, pool = tmodel.init_cache(2, max_len), tmodel.init_paged_cache(8, page)
    tk, ps = _ragged(tcfg, lens, 8, max_len, seed=2)
    got, pool = tmodel.decode_chunk_paged(tparams, pool, bt, _i32(tk[:, :4]), _i32(ps[:, :4]))
    want, dense = tmodel.decode_chunk(tparams, dense, _i32(tk[:, :4]), _i32(ps[:, :4]))
    assert torch.equal(got, want)
    for i in range(4, max(lens)):
        tkn = _i32([p[i] if i < len(p) else 0 for p in toks])
        pos = _i32([i if i < len(p) else max_len for p in toks])
        want, dense = tmodel.decode_step(tparams, dense, tkn, pos)
        got, pool = tmodel.decode_step_paged(tparams, pool, bt, tkn, pos)
        for b in range(2):
            if i < lens[b]:
                assert torch.equal(got[b], want[b])


def test_pad_sentinel_writes_nothing(gemma):
    """A lane at the pad position must not touch the pool, whatever token it
    carries: both rows of the table point at page 0."""
    _, (tcfg, tmodel, tparams) = gemma
    page = 4
    bt = _i32(np.zeros((2, 2)))
    pos = _i32([0, 2 * page])

    def pool_after(lane1_token):
        _, pool = tmodel.decode_step_paged(tparams, tmodel.init_paged_cache(2, page), bt,
                                           _i32([7, lane1_token]), pos)
        return pool

    a, b = pool_after(9), pool_after(123)
    assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    assert a["k"][:, 1].abs().sum() == 0 and a["k"][:, 0, 0].abs().sum() > 0


# ---------------------------------------------------------------------------
# engine level: the reference engine's token streams
# ---------------------------------------------------------------------------
def _engines(gemma, prompts, *, prefix=None, max_new=8, **cfg):
    """The same requests through the reference's engine and the port's;
    returns both engines and both token streams."""
    (_, jmodel, jparams), (_, tmodel, tparams) = gemma
    out = []
    for serve, model, params in ((jserve, jmodel, jparams), (tserve, tmodel, tparams)):
        eng = serve.ServeEngine(model, params, serve.EngineConfig(**cfg))
        if prefix is not None:
            eng.register_prefix(prefix)
        sessions = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run()
        assert all(s.done for s in sessions)
        out.append((eng, [s.out for s in sessions]))
    (je, jout), (te, tout) = out
    return je, te, jout, tout


SUMMARY_KEYS = ("requests", "generated_tokens", "prefill_tokens", "ticks", "preemptions",
                "prefix_hits", "prefix_tokens_reused", "pages_peak", "requeues")


def _same_summary(je, te):
    js, ts = je.summary(), te.summary()
    assert {k: ts[k] for k in SUMMARY_KEYS} == {k: js[k] for k in SUMMARY_KEYS}


@pytest.mark.parametrize("page_size", [4, 8])
def test_engine_paged_matches_dense_and_the_reference(gemma, page_size):
    (jcfg, _, _), (_, tmodel, tparams) = gemma
    prompts = _prompts(jcfg, 6, [5, 9, 3, 7, 11, 4], seed=0)
    base = dict(n_slots=3, max_len=24, prefill_chunk=4)
    je, te, jout, tout = _engines(gemma, prompts, page_size=page_size, **base)
    assert tout == jout
    _same_summary(je, te)
    assert te.allocator.used == 0 and te.summary()["pages_peak"] > 0
    dense = tserve.ServeEngine(tmodel, tparams, tserve.EngineConfig(**base))
    ss = [dense.submit(p, 8) for p in prompts]
    dense.run()
    assert [s.out for s in ss] == tout


def test_engine_page_exhaustion_preempts_cleanly_as_the_reference(gemma):
    (jcfg, _, _), _ = gemma
    prompts = _prompts(jcfg, 6, [5, 9, 3, 7, 11, 4], seed=0)
    je, te, jout, tout = _engines(gemma, prompts, n_slots=3, max_len=24, prefill_chunk=4,
                                  page_size=4, n_pages=8)
    assert tout == jout
    _same_summary(je, te)
    assert te.summary()["preemptions"] > 0 and te.allocator.used == 0
    assert ([s.stats.preemptions for s in te.finished]
            == [s.stats.preemptions for s in je.finished])


def test_engine_shared_prefix_fork_identical_to_the_reference(gemma):
    (jcfg, _, _), _ = gemma
    rng = np.random.default_rng(7)
    pfx = [int(t) for t in rng.integers(1, jcfg.vocab_size, 6)]
    prompts = [pfx + t for t in _prompts(jcfg, 4, [4, 2, 5, 3], seed=8)]
    je, te, jout, tout = _engines(gemma, prompts, prefix=pfx, n_slots=3, max_len=24,
                                  prefill_chunk=4, page_size=4)
    assert tout == jout
    _same_summary(je, te)
    s = te.summary()
    assert s["prefix_hits"] == len(prompts) and s["prefix_tokens_reused"] > 0
    prefix = te._prefixes[tuple(pfx)]
    assert prefix.hits == len(prompts) and te.allocator.used == len(prefix.pages)
    te.unregister_prefix(pfx)
    assert te.allocator.used == 0


def test_engine_prefix_page_boundary_cow_as_the_reference(gemma):
    """Reuse not page-aligned (a prefix of 1.5 pages): the fork copies the
    boundary page and continues inside it, prefix intact for later forks."""
    (jcfg, _, _), (_, tmodel, tparams) = gemma
    rng = np.random.default_rng(11)
    pfx = [int(t) for t in rng.integers(1, jcfg.vocab_size, 6)]
    prompts = [pfx + t for t in _prompts(jcfg, 3, [3, 5, 2], seed=12)]
    cfg = dict(n_slots=2, max_len=24, prefill_chunk=4, page_size=4)
    je, te, jout, tout = _engines(gemma, prompts, prefix=pfx, **cfg)
    assert tout == jout
    _same_summary(je, te)
    plain = tserve.ServeEngine(tmodel, tparams, tserve.EngineConfig(**cfg))
    ss = [plain.submit(p, 8) for p in prompts]
    plain.run()
    assert [s.out for s in ss] == tout
    assert plain.summary()["prefill_tokens"] > te.summary()["prefill_tokens"]


def test_engine_config_validation_as_the_reference():
    for kw, msg in (({"page_size": 0}, "page_size"), ({"n_pages": 8}, "requires page_size"),
                    ({"page_size": 4, "n_pages": 3}, "worst-case lane"),
                    ({"prefill_chunk": 0}, "prefill_chunk"), ({"guard": "x"}, "guard mode"),
                    ({"backend": "pallas"}, "unknown backend")):
        with pytest.raises(ValueError, match=msg):
            tserve.EngineConfig(n_slots=2, max_len=16, **kw)
    assert tserve.EngineConfig(n_slots=2, max_len=16, page_size=4).table_width == 4
    with pytest.raises(ValueError, match="paged-mode"):
        tserve.EngineConfig(n_slots=2, max_len=16).table_width


def test_register_prefix_requires_paged_and_keeps_lane_headroom(gemma):
    _, (_, tmodel, tparams) = gemma
    eng = tserve.ServeEngine(tmodel, tparams, tserve.EngineConfig(n_slots=2, max_len=16))
    with pytest.raises(ValueError, match="paged"):
        eng.register_prefix([1, 2, 3])
    eng = tserve.ServeEngine(tmodel, tparams,
                             tserve.EngineConfig(n_slots=2, max_len=16, page_size=4, n_pages=4))
    with pytest.raises(tserve.PagePoolExhausted):
        eng.register_prefix(list(range(1, 9)))  # 2 pages, leaves 2 < 4 headroom
    assert eng.allocator.used == 0
