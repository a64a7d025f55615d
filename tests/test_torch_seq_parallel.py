"""Sequence parallelism: the transformer's residual stream split on S over
``model``, where the reference pins it to ``("dp", "sp", None)``, against the
reference's one-device function, on gloo CPU ranks.

gemma-2b, olmoe-1b-7b, qwen2.5-14b and internvl2-76b ``reduced()``, in
float32, from the reference's init weights with every constant leaf
perturbed (``torch_tp_families.np_params``: the norm scales, which each
rank reads on its slice alone, and qwen's biases), on ``model`` meshes of 2
and 4 ranks.  Between them they hold the readers a split-to-whole gather
must get right: gemma's single KV head read whole, the KV heads split at
tp 2 and whole at tp 4 for the others, olmoe's router whole beside its
split experts, the tied and the untied vocab-split head, and the VLM's
frontend prepended to the stream before it is split.

- **The split**: each block's input in ``lm_forward`` and ``lm_prefill``
  is (B, S/tp, d) on every rank where tp divides S (S 32), and (B, S, d)
  where it does not (S 33 at tp 2, S 34 at tp 4).
- **Forward and prefill**: the logits, the prefill's last logits and each
  rank's cache (its KV heads) equal the reference's within
  ``guard.tolerance(float32, "nvidia-h100-sxm")``.
- **Gradients**: under remat's two policies, with the backward on another
  thread as the card runs it, every rank's grad of every leaf equals its
  slice of the reference's ``jax.grad``, within the same tolerance
  relative to each leaf's largest magnitude.
- **reduce_scatter**: a bf16 reduce-scatter on 2 and 4 ranks equals each
  rank's slice of the fp32 all-reduce of the same tensors, rounded once to
  bf16, and is recorded as a sum: its wire bytes are the fp32 bytes.

Each tp runs in one spawn, cached across the tests; both spawns run while
the reference computes its side.
"""
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.models import transformer as jtransformer
from repro_torch.dist import collectives, run_ranks
from repro_torch.launch.mesh import Mesh

import torch_dist_workers as workers
import torch_tp_families as fam

NAMES = ("gemma-2b", "olmoe-1b-7b", "qwen2.5-14b", "internvl2-76b")
SEQS = {2: (32, 33), 4: (32, 34)}  # a dividing and a non-dividing S per tp
POLICIES = ("full", "dots")
B = 2


def _case(name, s):
    """The batch whose stream holds ``s`` positions (a VLM's frontend among them)."""
    cfg = fam.jcfg(name, ())
    text = s - (cfg.frontend_len if cfg.family == "vlm" else 0)
    return fam.batch(name, (), b=B, s=text)


def _reference(name, s):
    """The reference's forward logits, prefill (last logits, cache) and
    loss with its grads, on one device."""
    cfg = fam.jcfg(name, ())
    model = jbuild(cfg)
    bt = {k: jnp.asarray(v) for k, v in _case(name, s).items()}
    feed = {k: v for k, v in bt.items() if k != "targets"}

    def run(p):
        logits = jtransformer.lm_forward(p, bt["tokens"], cfg, bt.get("frontend"))[0]
        last, cache = model.prefill(p, feed, s)
        loss, grads = jax.value_and_grad(model.loss_fn)(p, bt)
        return logits, last, cache, loss, grads

    logits, last, cache, loss, grads = jax.jit(run)(
        jax.tree.map(jnp.asarray, fam.np_params(name)))
    return {"logits": np.asarray(logits), "prefill_last": np.asarray(last),
            "cache": jax.tree.map(np.asarray, cache), "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads)}


@lru_cache(maxsize=None)
def _results():
    """Each tp's ranks' results, both spawns started first, and the
    reference's for every (name, S), computed while the ranks run."""
    with ThreadPoolExecutor(len(SEQS)) as pool:
        spawns = {tp: pool.submit(run_ranks, workers.seq_parallel, tp, tp,
                                  [(name, fam.np_params(name), _case(name, s))
                                   for s in SEQS[tp] for name in NAMES],
                                  device="cpu", timeout=300)
                  for tp in SEQS}
        refs = {(name, s): _reference(name, s)
                for name in NAMES for s in sorted({s for v in SEQS.values() for s in v})}
        return {tp: f.result() for tp, f in spawns.items()}, refs


def _ranks(tp):
    return _results()[0][tp]


def _got(tp, name, s):
    i = SEQS[tp].index(s) * len(NAMES) + NAMES.index(name)
    return [r["cases"][i] for r in _ranks(tp)]


def _want(name, s):
    return _results()[1][(name, s)]


CASES = [(tp, name, s) for tp in SEQS for name in NAMES for s in SEQS[tp]]
IDS = [f"tp{tp}-{name}-S{s}" for tp, name, s in CASES]


@pytest.mark.parametrize("tp,name,s", CASES, ids=IDS)
def test_the_stream_is_split_where_model_divides_s(tp, name, s):
    cfg = fam.jcfg(name, ())
    local = s // tp if s % tp == 0 else s
    for rank, got in enumerate(_got(tp, name, s)):
        for key in ("forward_inputs", "prefill_inputs"):
            assert got[key] == [(B, local, cfg.d_model)] * cfg.n_layers, (rank, key, got[key])


@pytest.mark.parametrize("tp,name,s", CASES, ids=IDS)
def test_forward_and_prefill_equal_the_reference(tp, name, s):
    want = _want(name, s)
    for rank, got in enumerate(_got(tp, name, s)):
        what = f"tp {tp} rank {rank}"
        np.testing.assert_allclose(got["logits"], want["logits"], err_msg=f"{what} logits",
                                   **fam.TOL)
        np.testing.assert_allclose(got["prefill_last"], want["prefill_last"],
                                   err_msg=f"{what} prefill", **fam.TOL)
        lo, hi = got["kv_heads"]
        for leaf in ("k", "v"):
            fam.close_scaled(got["cache"][leaf], want["cache"][leaf][:, :, :, lo:hi],
                             f"{what} cache {leaf}")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("tp,name,s", CASES, ids=IDS)
def test_grads_equal_the_references_slices(tp, name, s, policy):
    want = _want(name, s)
    for rank, got in enumerate(_got(tp, name, s)):
        mine = got[policy]
        np.testing.assert_allclose(mine["loss"], want["loss"], rtol=1e-5)
        for (path, g), (_, sl), (_, w) in zip(fam.leaves(mine["grads"]),
                                             fam.leaves(got["slices"]),
                                             fam.leaves(want["grads"])):
            fam.close_scaled(g, w[tuple(slice(a, b) for a, b in sl)],
                             f"tp {tp} rank {rank} {policy}: {path}")


@pytest.mark.parametrize("tp", sorted(SEQS))
def test_reduce_scatter_sums_16_bit_floats_in_fp32(tp):
    every = [workers.rs_inputs(r, tp) for r in range(tp)]
    numel = every[0].numel()
    fp32 = sum(x.float() for x in every)
    for rank, r in enumerate(_ranks(tp)):
        np.testing.assert_array_equal(r["all_reduce_fp32"], fp32.numpy())
        rounded = torch.from_numpy(r["all_reduce_fp32"]).bfloat16().float()
        for dim, got in enumerate(r["rs"]):
            n = rounded.shape[dim] // tp
            np.testing.assert_array_equal(got, rounded.narrow(dim, rank * n, n).numpy())
        assert r["rs_dtypes"] == ["torch.bfloat16"] * 2
        assert r["rs_calls"] == [("reduce_scatter", "model", tp, 2 * numel, 4 * numel)] * 2


def test_a_dry_reduce_scatter_is_recorded_as_a_sum():
    mesh = Mesh((4,), ("model",)).place(1, "meta")
    x = torch.empty((8, 3), dtype=torch.bfloat16, device="meta")
    with collectives.recording() as rec:
        y = collectives.reduce_scatter(x, mesh, "model", 0)
    assert (tuple(y.shape), y.dtype) == ((2, 3), torch.bfloat16)
    assert rec.calls == [collectives.CollectiveCall("reduce_scatter", "model", 4, 48, 96)]
