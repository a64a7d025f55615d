"""The port's MoE block against the reference on the CPU.

The same numpy inputs and the reference's own ``moe_init`` weights go
through ``repro.models.mlp`` (JAX) and ``repro_torch.models.mlp``: the
capacity-bounded dispatch at olmoe-1b-7b reduced's capacity factor 1.25 in
a case where assignments drop, both packages' dispatch against their
``moe_block_dense`` oracle when capacity is ample, the aux loss, the top-k
order among tied router probabilities, and ``moe_capacity`` over a range of
group lengths.  Tolerance: ``repro.kernels.guard.tolerance`` of the dtype
on the card (float32: 256 ulps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import guard
from repro.models import mlp as jmlp
from repro_torch import configs as tconfigs
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttr

_F32_TOL = guard.tolerance(np.float32, "nvidia-h100-sxm")
TOL = dict(rtol=_F32_TOL.rtol, atol=_F32_TOL.atol)
ARCH = "olmoe-1b-7b"


def _cfgs(**kw):
    return (jconfigs.get_config(ARCH).reduced().replace(**kw),
            tconfigs.get_config(ARCH).reduced().replace(**kw))


def _params(cfg, seed=0, tie_columns=False):
    """The reference's ``moe_init`` as numpy; ``tie_columns`` copies router
    column 0 into every column, so all router logits of a token tie."""
    p = jax.tree.map(np.asarray, jmlp.moe_init(jax.random.PRNGKey(seed), cfg))
    if tie_columns:
        p["router"] = np.repeat(p["router"][:, :1], cfg.n_experts, axis=1)
    return p


def _x(cfg, shape, seed, skew=0.0):
    """Normal activations plus ``skew`` times one shared direction: a skew
    gives every token similar router logits, so the same experts fill up."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, cfg.d_model))
    x += skew * rng.normal(size=cfg.d_model)
    return x.astype(np.float32)


def _both(fn_name, jcfg, tcfg, p, x):
    want = getattr(jmlp, fn_name)(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    got = getattr(tmlp, fn_name)({k: torch.tensor(v) for k, v in p.items()},
                                 torch.from_numpy(x), tcfg)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _drops(cfg, p, x) -> int:
    """Assignments past capacity, counted independently of both packages:
    the reference's top-k (``jax.lax.top_k``) per routing group, each
    expert's assignments beyond ``moe_capacity``."""
    logits = x @ p["router"]
    _, top_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1),
                             cfg.experts_per_token)
    top_e = np.asarray(top_e)
    cap = jmlp.moe_capacity(cfg, x.shape[1])
    return sum(max(0, int(np.sum(g == e)) - cap)
               for g in top_e for e in range(cfg.n_experts))


def test_moe_block_with_drops_matches_reference():
    jcfg, tcfg = _cfgs()
    assert jcfg.capacity_factor == 1.25
    p = _params(jcfg)
    x = _x(jcfg, (3, 48), 1, skew=3.0)
    assert _drops(jcfg, p, x) > 0  # capacity bites in this case
    (wy, waux), (gy, gaux) = _both("moe_block", jcfg, tcfg, p, x)
    np.testing.assert_allclose(gy, wy, **TOL)
    np.testing.assert_allclose(gaux, waux, **TOL)
    # the drops change the output: the dense oracle differs from it
    (dy, _), _ = _both("moe_block_dense", jcfg, tcfg, p, x)
    assert np.abs(dy - wy).max() > 1e-2


@pytest.mark.parametrize("skew,real_len", [(0.0, None), (3.0, None), (3.0, 40)])
def test_moe_drop_count_matches_the_independent_count(skew, real_len):
    """``moe_drop_count`` against ``_drops`` on the same groups; with a
    mask, only each lane's first ``real_len`` tokens count, as a serving
    step's pad entries after them are left out."""
    jcfg, tcfg = _cfgs()
    p = _params(jcfg, seed=10)
    x = _x(jcfg, (3, 48), 11, skew=skew)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    if real_len is None:
        got = tmlp.moe_drop_count(tp, torch.from_numpy(x), tcfg)
        want = _drops(jcfg, p, x)
    else:
        real = torch.arange(x.shape[1])[None, :].expand(x.shape[0], -1) < real_len
        got = tmlp.moe_drop_count(tp, torch.from_numpy(x), tcfg, real)
        # the real tokens alone, against the capacity of the whole group
        logits = x[:, :real_len] @ p["router"]
        _, top_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1),
                                 jcfg.experts_per_token)
        cap = jmlp.moe_capacity(jcfg, x.shape[1])
        want = sum(max(0, int(np.sum(np.asarray(g) == e)) - cap)
                   for g in top_e for e in range(jcfg.n_experts))
        assert int(got) < _drops(jcfg, p, x)  # the pads' own drops are left out
    assert got.shape == () and int(got) == want
    assert skew == 0.0 or want > 0


@pytest.mark.parametrize("skew", [0.0, 3.0])
def test_ample_capacity_equals_the_dense_oracle_in_both_packages(skew):
    jcfg, tcfg = _cfgs(capacity_factor=16.0)
    p = _params(jcfg, seed=2)
    x = _x(jcfg, (2, 40), 3, skew=skew)
    assert _drops(jcfg, p, x) == 0
    (wy, waux), (gy, gaux) = _both("moe_block", jcfg, tcfg, p, x)
    (dwy, dwaux), (dgy, dgaux) = _both("moe_block_dense", jcfg, tcfg, p, x)
    for got in (gy, dgy, dwy):
        np.testing.assert_allclose(got, wy, **TOL)
    for got in (gaux, dgaux, dwaux):
        np.testing.assert_allclose(got, waux, **TOL)


@pytest.mark.parametrize("skew", [0.0, 3.0])
def test_aux_loss_matches_reference(skew):
    jcfg, tcfg = _cfgs()
    p = _params(jcfg, seed=4)
    x = _x(jcfg, (4, 24), 5, skew=skew)
    (_, waux), (_, gaux) = _both("moe_block", jcfg, tcfg, p, x)
    np.testing.assert_allclose(gaux, waux, **TOL)
    assert gaux.shape == () and gaux.dtype == np.float32


def test_tied_router_probabilities_take_the_references_expert_order():
    jcfg, tcfg = _cfgs()
    p = _params(jcfg, seed=6, tie_columns=True)
    x = _x(jcfg, (2, 20), 7)
    probs = jax.nn.softmax(jnp.asarray(x @ p["router"]), axis=-1)
    _, want_e = jax.lax.top_k(probs, jcfg.experts_per_token)
    _, _, got_e = tmlp._route({k: torch.tensor(v) for k, v in p.items()},
                              torch.from_numpy(x), jcfg.experts_per_token)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    assert (got_e.numpy() == np.arange(jcfg.experts_per_token)).all()  # lowest index first
    # every token on the first k experts: 20 tokens over a capacity of 16 drop
    assert _drops(jcfg, p, x) > 0
    for fn in ("moe_block", "moe_block_dense"):
        (wy, waux), (gy, gaux) = _both(fn, jcfg, tcfg, p, x)
        np.testing.assert_allclose(gy, wy, **TOL)
        np.testing.assert_allclose(gaux, waux, **TOL)


@pytest.mark.parametrize("factor", [1.0, 1.25, 2.0, 16.0])
def test_moe_capacity_matches_reference(factor):
    for arch in ("olmoe-1b-7b", "dbrx-132b"):
        jcfg = jconfigs.get_config(arch).replace(capacity_factor=factor)
        tcfg = tconfigs.get_config(arch).replace(capacity_factor=factor)
        for tokens in (1, 7, 8, 31, 128, 256, 1000, 1056, 4096):
            assert tmlp.moe_capacity(tcfg, tokens) == jmlp.moe_capacity(jcfg, tokens)
    cfg = tconfigs.get_config("olmoe-1b-7b")
    assert [tmlp.moe_capacity(cfg, t) for t in (1, 128, 1000)] == [8, 24, 160]


def test_moe_init_layout_matches_reference():
    jcfg, tcfg = _cfgs()
    want = _params(jcfg)
    got = tmlp.moe_init(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    stacked = tmlp.moe_init(torch.Generator().manual_seed(0), tcfg, stack=(3,))
    assert stacked["wi_gate"].shape == (3, tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
    lm = ttr.lm_init(torch.Generator().manual_seed(0), tcfg)
    assert "mlp" not in lm["layers"] and lm["layers"]["moe"]["wo"].shape == (
        tcfg.n_layers, tcfg.n_experts, tcfg.d_ff, tcfg.d_model)


def test_bf16_moe_block_matches_reference_at_ample_capacity():
    """bf16 activations: the router logits in bf16 then fp32, the expert
    einsums in bf16, as the reference; within the reference's bf16
    tolerance."""
    jcfg, tcfg = _cfgs(capacity_factor=16.0)
    tol16 = guard.tolerance(jnp.bfloat16, "nvidia-h100-sxm")
    p = _params(jcfg, seed=8)
    x = _x(jcfg, (2, 16), 9)
    want, aux = jmlp.moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x, jnp.bfloat16), jcfg)
    got, gaux = tmlp.moe_block({k: torch.tensor(v) for k, v in p.items()},
                               torch.from_numpy(x).bfloat16(), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol16.rtol, atol=tol16.atol)
    np.testing.assert_allclose(gaux.numpy(), np.asarray(aux), **TOL)
