"""Shared parts of the tests of the serving engine on a mesh with a
``data`` or ``pod`` axis, four CPU ranks over gloo
(``tests/test_torch_dp_engine_*.py``, one file a mesh).

Each mesh serves ``tests/test_cluster.py``'s tensor-parallel workload
(4 prompts, 6 new tokens, max_len 32, chunk 4) through dense and paged
engines with 2 and 3 slots, for gemma-2b and olmoe-1b-7b ``reduced()``.
Every rank's streams must equal the port's one-device engine's and the
reference's no-mesh engine's, and each rank's local param and cache shapes
must be what the sharding rules give at its coordinates: params split over
``model`` and whole over ``data``/``pod``; the dense cache's lanes on
``pod``/``data`` where ``n_slots`` divides them (2 slots on two, 3 slots
whole), the paged pool's pages whole.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.dist import cache_shardings, paged_cache_shardings, param_specs, run_ranks
from repro_torch.dist.sharding import local_index, tree_leaves
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import EngineConfig, ServeEngine

import torch_dist_workers as workers

PROMPTS = [[1 + (i % 5), 2, 3 + i % 7] for i in range(4)]
MAX_NEW = 6
MAX_LEN = 32
NAMES = ("gemma-2b", "olmoe-1b-7b")
MESHES = {"data2_model2": ((2, 2), ("data", "model")), "data4": ((4,), ("data",)),
          "pod2_model2": ((2, 2), ("pod", "model"))}
CASES = [(name, page, slots) for name in NAMES for page in (None, 4) for slots in (2, 3)]


@lru_cache(maxsize=None)
def _np_params(name):
    cfg = jconfigs.get_config(name).reduced()
    return jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.key(0)))


@lru_cache(maxsize=None)
def _reference(name, slots):
    """The reference's no-mesh engine's streams."""
    model = jbuild(jconfigs.get_config(name).reduced())
    engine = jserve.ServeEngine(model, jax.tree.map(jnp.asarray, _np_params(name)),
                                jserve.EngineConfig(n_slots=slots, max_len=MAX_LEN,
                                                    prefill_chunk=4))
    sessions = [engine.submit(p, MAX_NEW) for p in PROMPTS]
    engine.run()
    return [s.out for s in sessions]


@lru_cache(maxsize=None)
def _one_device(name, page, slots):
    """The port's one-device engine's streams."""
    cfg = tconfigs.get_config(name).reduced()
    engine = ServeEngine(build_model(cfg, device="cpu"),
                         params_from_jax(_np_params(name), cfg, device="cpu"),
                         EngineConfig(n_slots=slots, max_len=MAX_LEN, prefill_chunk=4,
                                      page_size=page))
    sessions = [engine.submit(p, MAX_NEW) for p in PROMPTS]
    engine.run()
    return [s.out for s in sessions]


@lru_cache(maxsize=None)
def _served(mesh_name):
    shape, axes = MESHES[mesh_name]
    cases = [(name, _np_params(name), page, slots) for name, page, slots in CASES]
    res = run_ranks(workers.dp_engines, 4, shape, axes, cases, PROMPTS, MAX_NEW, device="cpu",
                    timeout=300)
    return {case: [r[i] for r in res] for i, case in enumerate(CASES)}


def _rule_shapes(tree, specs, mesh, rank) -> list:
    mesh.place(rank, "cpu")
    return [tuple(s.stop - s.start for s in local_index(sh, t.shape))
            for t, sh in zip(tree_leaves(tree), tree_leaves(specs))]


def check(mesh_name, name, page, slots):
    """Every rank's streams and local shapes on ``mesh_name`` (see the
    module docstring)."""
    want = _reference(name, slots)
    assert _one_device(name, page, slots) == want
    shape, axes = MESHES[mesh_name]
    cfg = tconfigs.get_config(name).reduced()
    model = build_model(cfg, device="cpu")
    params = params_from_jax(_np_params(name), cfg, device="cpu")
    cache = (model.init_cache(slots, MAX_LEN) if page is None
             else model.init_paged_cache(slots * -(-MAX_LEN // page), page))
    mesh = Mesh(shape, axes)
    pspecs = param_specs(params, cfg, mesh)
    cspecs = (cache_shardings if page is None else paged_cache_shardings)(cache, cfg, mesh)
    for rank, r in enumerate(_served(mesh_name)[(name, page, slots)]):
        assert r["tokens"] == want, (mesh_name, name, page, slots, rank)
        assert r["params"] == _rule_shapes(params, pspecs, mesh, rank)
        assert r["cache"] == _rule_shapes(cache, cspecs, mesh, rank)
        lanes = r["cache"][0][1]
        dp = mesh.size // mesh.shape.get("model", 1)
        if page is None:  # the lanes split where the slots divide the batch axes
            assert lanes == (slots // dp if slots % dp == 0 else slots)
        else:  # the pool's pages whole on every rank
            assert lanes == slots * -(-MAX_LEN // page)
