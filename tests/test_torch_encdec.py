"""The port's encoder-decoder (whisper) against the reference on the CPU.

The same numpy inputs, and the reference's own ``encdec_init`` weights
carried across by ``params_from_jax``, go through ``repro.models.encdec``
(JAX; the Pallas flash kernel in interpret mode for ``attn_impl="pallas"``,
as the reference's tests run it) and ``repro_torch.models.encdec`` (whose
kernel wrappers take their plain versions on CPU tensors) at whisper-base
reduced: ``layernorm``, ``sinusoidal_positions``, ``encode``, ``loss_fn``,
``prefill`` (every cache leaf) and greedy ``decode_step``s.  Tolerance:
``repro.kernels.guard.tolerance(float32)`` on the card (256 ulps); greedy
tokens identical.  The sinusoid's angles reach the table's length in
radians, so its own comparison at 1500 frames allows two ulps of that
angle (one measured).
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import guard
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.models import encdec as jed
from repro_torch import configs as tconfigs
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as ted
from repro_torch.models.convert import params_from_jax

_F32_TOL = guard.tolerance(np.float32, "nvidia-h100-sxm")
TOL = dict(rtol=_F32_TOL.rtol, atol=_F32_TOL.atol)
ARCH = "whisper-base"
IMPLS = ("pallas", "blockwise")
PROMPT, NEW = 10, 6


def _cfgs(impl="blockwise"):
    return (jconfigs.get_config(ARCH).reduced().replace(attn_impl=impl),
            tconfigs.get_config(ARCH).reduced().replace(attn_impl=impl))


@lru_cache(maxsize=None)
def _jax_params():
    """The reference's init as numpy, with the layer norms' scales and
    biases and the qkv biases (ones and zeros at init) perturbed so the
    parity covers them."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    p = jax.tree.map(np.asarray, jed.encdec_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("scale", "bias", "bq", "bk", "bv"):
                tree[k] = ((1.0 if k == "scale" else 0.0)
                           + 0.1 * rng.normal(size=v.shape)).astype(np.float32)

    perturb(p)
    return p


def _inputs(cfg, seed, batch=2, prompt=PROMPT):
    rng = np.random.default_rng(seed)
    return {
        "frontend": rng.normal(size=(batch, cfg.frontend_len, cfg.d_model)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32),
    }


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 512)])
def test_layernorm_parity(shape):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=shape) + 1.0).astype(np.float32)
    d = shape[-1]
    p = {"scale": (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32),
         "bias": (0.1 * rng.normal(size=d)).astype(np.float32)}
    want = jcommon.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), 1e-5)
    got = tcommon.layernorm({k: torch.tensor(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tcommon.layernorm({k: torch.tensor(v) for k, v in p.items()},
                             torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16
    init = tcommon.layernorm_init(d, stack=(3,))
    assert init["scale"].shape == init["bias"].shape == (3, d)
    assert set(init) == set(jcommon.layernorm_init(d))


@pytest.mark.parametrize("length,d_model", [(8, 64), (40, 64), (1500, 512)])
def test_sinusoidal_positions_parity(length, d_model):
    want = np.asarray(jcommon.sinusoidal_positions(length, d_model))
    got = tcommon.sinusoidal_positions(length, d_model).numpy()
    assert got.shape == want.shape == (length, d_model) and got.dtype == np.float32
    # |sin'| <= 1, so two libraries apart by an ulp of the angle stay within it
    atol = 2 * float(np.spacing(np.float32(length)))
    np.testing.assert_allclose(got, want, rtol=0, atol=max(atol, TOL["atol"]))


# ---------------------------------------------------------------------------
# the model, end to end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_encode_and_loss_parity(impl):
    jcfg, tcfg = _cfgs(impl)
    jp = _jax_params()
    tp = params_from_jax(jp, tcfg, device="cpu")
    batch = _inputs(jcfg, 11)
    want = jax.jit(lambda p, f: jed.encode(p, f, jcfg))(jp, batch["frontend"])
    got = ted.encode(tp, torch.from_numpy(batch["frontend"]), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    logits = ted.decode_train(tp, torch.from_numpy(batch["tokens"]), got, tcfg)
    want_logits = jed.decode_train(jp, batch["tokens"], want, jcfg)
    assert logits.shape == (2, PROMPT, tcfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    want_loss = jbuild(jcfg).loss_fn(jp, batch)
    got_loss = tbuild(tcfg, device="cpu").loss_fn(tp, _t(batch))
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_greedy_decode_parity(impl):
    jcfg, tcfg = _cfgs(impl)
    jp = _jax_params()
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg, device="cpu")
    tp = params_from_jax(jp, tcfg, device="cpu")
    batch = _inputs(jcfg, 13)
    del batch["targets"]
    max_len = PROMPT + NEW

    jlast, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len))(jp, batch)
    tlast, tcache = tmodel.prefill(tp, _t(batch), max_len)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    assert set(tcache) == set(jcache)
    for key in jcache:
        assert tcache[key].shape == jcache[key].shape
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)

    jstep = jax.jit(jmodel.decode_step)
    jtok, ttok = jnp.argmax(jlast, -1).astype(jnp.int32), tlast.argmax(-1)
    jseq, tseq = [], []
    for i in range(NEW):
        pos = np.full((2,), PROMPT + i, np.int32)
        jlog, jcache = jstep(jp, jcache, jtok, pos)
        tlog, tcache = tmodel.decode_step(tp, tcache, ttok, torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        jtok, ttok = jnp.argmax(jlog, -1).astype(jnp.int32), tlog.argmax(-1)
        jseq.append(np.asarray(jtok))
        tseq.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tseq), np.stack(jseq))
    for key in jcache:
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)


def test_bf16_prefill_keeps_a_bf16_cache_as_the_reference():
    jcfg, tcfg = (c.replace(dtype="bfloat16") for c in _cfgs())
    jp = _jax_params()
    tp = params_from_jax(jp, tcfg, device="cpu")
    batch = _inputs(jcfg, 17, batch=1)
    del batch["targets"]
    jlast, jcache = jbuild(jcfg).prefill(jp, batch, PROMPT + 2)
    tlast, tcache = tbuild(tcfg, device="cpu").prefill(tp, _t(batch), PROMPT + 2)
    tol = guard.tolerance(jnp.bfloat16, "nvidia-h100-sxm")
    for key in jcache:
        assert tcache[key].dtype == torch.bfloat16 and jcache[key].dtype == jnp.bfloat16
    # 2 + 2 layers of bf16 rounding: the logits compared at the row's scale
    scale = float(np.abs(np.asarray(jlast, np.float32)).max())
    np.testing.assert_allclose(tlast.float().numpy(), np.asarray(jlast, np.float32),
                               rtol=0, atol=8 * tol.rtol * scale)


def test_encdec_params_cache_and_api_surface():
    _, tcfg = _cfgs()
    conv = params_from_jax(_jax_params(), tcfg, device="cpu")
    fresh = ted.encdec_init(torch.Generator().manual_seed(0), tcfg)
    shapes = lambda t: tcommon.tree_map(lambda a: (tuple(a.shape), a.dtype), t)
    assert shapes(conv) == shapes(fresh)
    with pytest.raises(ValueError, match="expected"):
        params_from_jax({"embed": np.zeros((4, 4), np.float32)}, tcfg, device="cpu")
    model = tbuild(tcfg, device="cpu")
    specs, cache = model.cache_specs(3, 12), model.init_cache(3, 12)
    want = jed.encdec_cache_specs(_cfgs()[0], 3, 12, jnp.float32)
    for key, sd in want.items():
        assert tuple(specs[key].shape) == tuple(cache[key].shape) == sd.shape
        assert specs[key].device.type == "meta" and cache[key].device.type == "cpu"
    assert model.decode_chunk is None and model.decode_step_paged is None
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill(fresh, _t({k: v for k, v in _inputs(tcfg, 1).items() if k != "targets"}),
                      PROMPT - 1)
