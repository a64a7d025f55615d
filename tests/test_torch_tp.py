"""Tensor-parallel serving of the port against the reference, on gloo CPU
ranks.

Engines on a 1-D ``model`` mesh of 1, 2 and 4 ranks, dense and paged, serve
the requests of ``tests/test_cluster.py``'s tensor-parallel test from the
reference's weights (``params_from_jax``); every rank's token streams must
equal the reference's no-mesh engine, as that test asserts for the
reference's own meshes.  gemma-2b ``reduced()`` (4 query heads, 1 KV head:
the KV head stays whole) runs at every tp; olmoe-1b-7b ``reduced()`` (4
query heads, 2 KV heads, 4 experts) at tp 4, where each rank's one query
head reads global KV head ``rank // 2`` with the KV heads whole (the local
grouping would read head 0), and its experts are spread one a rank;
qwen2.5-14b ``reduced()`` (2 KV heads, q/k/v biases) at tp 2 splits its KV
heads and slices its replicated biases to the local heads; internvl2-76b
``reduced()`` (the VLM, served text requests) at tp 2 splits its 2 KV
heads.  The
prefill's gathered last logits under the mesh hold against the reference's
prefill within ``guard.tolerance(float32, "nvidia-h100-sxm")`` (256 ulps):
the row-parallel sums add the ranks' partials in another order.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.kernels import guard
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.dist import run_ranks
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import activation_sharding, tree_leaves
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.serve.cluster import replica_meshes

import torch_dist_workers as workers

_F32 = guard.tolerance(np.float32, "nvidia-h100-sxm")
PROMPTS = [[1 + (i % 5), 2, 3 + i % 7] for i in range(4)]
MAX_NEW = 6
TPS = (1, 2, 4)
NAMES_AT = {1: ("gemma-2b",), 2: ("gemma-2b", "qwen2.5-14b", "internvl2-76b"),
            4: ("gemma-2b", "olmoe-1b-7b")}
GAINED_TP = ("zamba2-7b", "xlstm-1.3b")  # families that gained a tensor-parallel forward


@lru_cache(maxsize=None)
def _np_params(name):
    cfg = jconfigs.get_config(name).reduced()
    return jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.key(0)))


@lru_cache(maxsize=None)
def _reference(name):
    """The reference's no-mesh engine's token streams and its prefill's
    last logits of the first prompt."""
    cfg = jconfigs.get_config(name).reduced()
    model = jbuild(cfg)
    params = jax.tree.map(jnp.asarray, _np_params(name))
    engine = jserve.ServeEngine(model, params, jserve.EngineConfig(
        n_slots=2, max_len=32, prefill_chunk=4))
    sessions = [engine.submit(p, MAX_NEW) for p in PROMPTS]
    engine.run()
    logits, _ = model.prefill(params, {"tokens": jnp.asarray([PROMPTS[0]], jnp.int32)})
    return [s.out for s in sessions], np.asarray(logits)


@lru_cache(maxsize=None)
def _served(n):
    """Every rank's results at tp ``n``: per (name, page_size) case."""
    cases = [(name, _np_params(name), ps) for name in NAMES_AT[n] for ps in (None, 4)]
    res = run_ranks(workers.tp_engines, n, n, cases, PROMPTS, MAX_NEW, device="cpu",
                    timeout=300)
    return {(name, ps): [r[i] for r in res] for i, (name, _, ps) in enumerate(cases)}


@pytest.mark.parametrize("n,name,page_size",
                         [(n, name, ps) for n in TPS for name in NAMES_AT[n] for ps in (None, 4)])
def test_tp_engine_streams_equal_the_reference(n, name, page_size):
    want, want_logits = _reference(name)
    cfg = tconfigs.get_config(name).reduced()
    for rank, r in enumerate(_served(n)[(name, page_size)]):
        assert r["tokens"] == want, (n, name, page_size, rank)
        np.testing.assert_allclose(r["logits"], want_logits, rtol=_F32.rtol, atol=_F32.atol)
        # the placement the rules chose: heads and vocab split, KV heads whole
        # unless the axis divides them
        assert r["wq_heads"] == (cfg.n_heads // n if cfg.n_heads % n == 0 else cfg.n_heads)
        assert r["embed_rows"] == cfg.padded_vocab // n
        kv = cfg.n_kv_heads // n if cfg.n_kv_heads % n == 0 else cfg.n_kv_heads
        assert r["cache_heads"] == kv


def test_kv_heads_for_local_query_heads():
    """Global query head h reads KV head h // (H / K) on every rank."""

    class Axis:  # a bound mesh's surface, for one rank's index
        def __init__(self, n, i):
            self.shape, self.i = {"model": n}, i

        def index(self, axis):
            return self.i

    def read(h, k, n, i):
        with activation_sharding(Axis(n, i)):
            sel = tp.kv_heads_for_local_q(h, k, k if k % n else k // n)
            lo, hi = tp.local_range(h)
        local_q = hi - lo
        kv = list(range(k if k % n else k // n))
        if sel is not None:
            kv = kv[sel] if isinstance(sel, slice) else [kv[j] for j in sel.tolist()]
        group = local_q // len(kv)
        base = 0 if k % n else i * (k // n)  # a split KV axis starts at the rank's slice
        return [base + kv[j // group] for j in range(local_q)]

    for h, k, n in ((4, 2, 4), (4, 1, 2), (8, 1, 2), (6, 2, 2), (8, 4, 2), (12, 3, 2),
                    (6, 2, 3), (16, 16, 4)):
        if h % n:
            continue
        for i in range(n):
            lo = i * (h // n)
            assert read(h, k, n, i) == [(lo + j) // (h // k) for j in range(h // n)], (h, k, n, i)


@lru_cache(maxsize=None)
def _value_and_grad_on_a_model_axis():
    (got, _) = run_ranks(workers.tp_value_and_grad_families, 2, GAINED_TP, device="cpu",
                         timeout=120)
    return got


@pytest.mark.parametrize("name", GAINED_TP)
def test_families_without_a_tp_forward_refuse_a_model_axis(name):
    """The name is the one this test had while these families refused a
    2-rank ``model`` mesh.  They have a tensor-parallel forward now: the
    test checks that a ``value_and_grad`` there runs, with no refusal,
    through the ``model`` axis's collectives (``tests/test_torch_tp_hybrid.py``
    and ``tests/test_torch_tp_families.py`` hold its results to the
    reference's)."""
    msg, issued = _value_and_grad_on_a_model_axis()[name]
    assert msg is None, msg
    assert "all_reduce" in issued and "all_gather" in issued


def test_engine_refuses_what_waits():
    """The name is the one this test had while the engine refused a
    ``data``/``pod`` axis.  It takes one now: on a (data 2, model 1) mesh
    placed at rank 1, the params are placed whole over ``data`` and the
    cache keeps the lanes of data index 1.  The VLM and tensor-parallel
    replicas no longer wait either."""
    cfg = tconfigs.get_config("gemma-2b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, EngineConfig(
        n_slots=2, max_len=16, mesh=Mesh((2, 1), ("data", "model")).place(1, "cpu")))
    for got, want in zip(tree_leaves(eng.params), tree_leaves(params)):
        assert torch.equal(got, want)
    assert eng.cache["k"].shape == (cfg.n_layers, 1, 16, cfg.n_kv_heads, cfg.head_dim)
    assert eng._lanes == slice(1, 2) and eng._lane_axes == ("data",)
    vlm = build_model(tconfigs.get_config("internvl2-76b").reduced(), device="cpu")
    with pytest.raises(RuntimeError, match="abstract"):  # past the refusal, to placement
        ServeEngine(vlm, None, EngineConfig(n_slots=2, max_len=16,
                                            mesh=Mesh((2,), ("model",))))
    cpu = torch.device("cpu")
    assert replica_meshes(2, tp=2, devices=["cpu", "cpu"]) == [(cpu, cpu), (cpu, cpu)]
