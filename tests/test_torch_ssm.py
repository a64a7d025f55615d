"""The port's SSD scan and Mamba2 block against the reference on the CPU.

The same numpy inputs go through ``repro`` (the Pallas ``_ssd_kernel`` in
interpret mode, as the reference's tests run it, or its ``xla`` oracle) and
through ``repro_torch``: the ``ssm_scan`` op's ``torch`` backend (the
sequential recurrence), its ``cuda`` implementation called on CPU tensors
(the wrapper's chunk clamp, padding and slicing around the kernel's plain
version, ``ref.ssm_scan_chunked_ref``), the model-level ``ssd_chunked`` and
the Mamba2 block.  Tolerances: float32 throughout; 2e-4 for the scan against
the Pallas kernel (a different summation order over up to 128 steps, the
reference tests' own), 1e-5 for the chunked plain version against the Pallas
kernel (the same chunked arithmetic), 1e-4 for the model functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import api as japi
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro.models import mamba as jmamba
from repro_torch import configs as tconfigs
from repro_torch.kernels import _util
from repro_torch.kernels import api as tapi
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssm_scan import ssm_scan_cuda
from repro_torch.models import mamba as tmamba

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _scan_inputs(bsz, s, h, p, n, seed):
    u = _np((bsz, s, h, p), seed)
    a = -np.abs(_np((bsz, s, h), seed + 1)) * 0.2
    return u, a, _np((bsz, s, n), seed + 2), _np((bsz, s, n), seed + 3)


@pytest.mark.parametrize("seq,chunk", [(64, 16), (128, 32), (100, 32), (40, 256)])
def test_ssm_scan_matches_the_pallas_kernel(seq, chunk):
    """S = 100 pads to 128; chunk 256 clamps to S = 40, as fit_block does."""
    ins = _scan_inputs(2, seq, 3, 8, 4, seed=seq + chunk)
    want = japi.ssm_scan(*map(jnp.asarray, ins), chunk=chunk, backend="pallas")
    t = [torch.from_numpy(x) for x in ins]
    for got in (tapi.ssm_scan(*t, chunk=chunk), tapi.ssm_scan.impl("cuda")(*t, chunk=chunk)):
        assert got.shape == (2, seq, 3, 8) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_chunked_plain_version_where_the_clip_binds():
    """a_log = -1 a step: within a chunk of 128, acum_t - acum_s reaches
    -127, so exp is clipped at -60 and exp(acum) underflows to 0, as the
    reference computes it."""
    bh, s, p, n = 3, 256, 8, 4
    u, b, c = _np((bh, s, p), 1), _np((bh, s, n), 2), _np((bh, s, n), 3)
    a = -np.ones((bh, s), np.float32)
    want = ssm_scan_pallas(*map(jnp.asarray, (u, a, b, c)), chunk=128, interpret=True)
    got = tref.ssm_scan_chunked_ref(*map(torch.from_numpy, (u, a, b, c)), 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        tref.ssm_scan_chunked_ref(*map(torch.from_numpy, (u, a, b, c)), 100)


def test_kernel_wrapper_reads_the_model_layout():
    """ssm_scan_cuda takes head-shared b/c (B,S,N); on CPU tensors its plain
    version sees them expanded per head, as flatten_ssm gives them."""
    ins = _scan_inputs(2, 48, 3, 8, 4, seed=5)
    t = [torch.from_numpy(x) for x in ins]
    got = ssm_scan_cuda(*t, chunk=16)
    want = tref.ssm_scan_chunked_ref(*_util.flatten_ssm(*t), 16)
    np.testing.assert_allclose(got.numpy(), _util.unflatten_heads(want, 2).numpy(), rtol=0, atol=0)
    seq = tref.ssm_scan_ref(*_util.flatten_ssm(*t))
    np.testing.assert_allclose(got.numpy(), _util.unflatten_heads(seq, 2).numpy(), rtol=2e-4,
                               atol=2e-4)
    # a_log in bf16 is widened, as the reference's kernel casts it
    got16 = ssm_scan_cuda(t[0], t[1].bfloat16(), t[2], t[3], chunk=16)
    want16 = ssm_scan_cuda(t[0], t[1].bfloat16().float(), t[2], t[3], chunk=16)
    assert torch.equal(got16, want16)


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(chunk=20), ValueError, "divide"),
    (dict(chunk=512), ValueError, "chunk"),
    (dict(p=130), ValueError, "up to 128"),
    (dict(n=129), ValueError, "up to 128"),
    (dict(b_dtype=torch.float64), TypeError, "share a dtype"),
    (dict(bad_b=True), ValueError, "match"),
])
def test_kernel_wrapper_checks_its_inputs(kwargs, exc, match):
    p, n, s = kwargs.get("p", 8), kwargs.get("n", 4), 512
    u = torch.zeros((1, s, 2, p))
    a = torch.zeros((1, s, 2))
    b = torch.zeros((1, s // 2 if kwargs.get("bad_b") else s, n),
                    dtype=kwargs.get("b_dtype", torch.float32))
    with pytest.raises(exc, match=match):
        ssm_scan_cuda(u, a, b, b, chunk=kwargs.get("chunk", 256))


def test_ssm_scan_cuda_backend_needs_cuda_tensors():
    t = [torch.from_numpy(x) for x in _scan_inputs(1, 16, 2, 8, 4, seed=9)]
    assert tapi.get_op("ssm_scan").impl("cuda") is not None
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tapi.ssm_scan(*t, backend="cuda")


def test_ssd_chunked_with_initial_state():
    bsz, s, h, p, n = 2, 40, 3, 8, 4
    u, a, b, c = _scan_inputs(bsz, s, h, p, n, seed=21)
    h0 = _np((bsz, h, p, n), 25)
    want_y, want_h = jmamba.ssd_chunked(*map(jnp.asarray, (u, a, b, c, h0)), 16)
    got_y, got_h = tmamba.ssd_chunked(*map(torch.from_numpy, (u, a, b, c, h0)), 16)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


def _mamba_params(jcfg):
    """The reference's mamba_init, with the norm scales, D, dt_bias and A_log
    (ones and zeros at init) perturbed so the parity covers them."""
    p = jax.tree.map(np.asarray, jmamba.mamba_init(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(4)
    for name in ("D", "dt_bias", "A_log", "conv_b"):
        p[name] = (p[name] + 0.3 * rng.normal(size=p[name].shape)).astype(np.float32)
    for norm in (p["norm"], p["out_norm"]):
        norm["scale"] = (1.0 + 0.1 * rng.normal(size=norm["scale"].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mamba_forward_parity(impl):
    jcfg = jconfigs.get_config("zamba2-7b").reduced().replace(ssm_impl=impl)
    tcfg = tconfigs.get_config("zamba2-7b").reduced().replace(ssm_impl=impl)
    jp = _mamba_params(jcfg)
    tp = _to_torch(jp)
    x = _np((2, 40, jcfg.d_model), 6)
    want = jmamba.mamba_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg)
    got = tmamba.mamba_forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_y, want_h = jmamba.mamba_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg,
                                          return_state=True)
    got_y, got_h = tmamba.mamba_forward(tp, torch.from_numpy(x), tcfg, return_state=True)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()}


def test_mamba_decode_parity():
    jcfg = jconfigs.get_config("zamba2-7b").reduced()
    jp = _mamba_params(jcfg)
    d_in, h, conv_dim = jmamba.mamba_dims(jcfg)
    x = _np((2, jcfg.d_model), 7)
    ssm = _np((2, h, jcfg.ssm_head_dim, jcfg.ssm_state), 8)
    conv = _np((2, jcfg.ssm_conv_width - 1, conv_dim), 9)
    want = jmamba.mamba_decode(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg,
                               jnp.asarray(ssm), jnp.asarray(conv))
    tssm, tconv = torch.from_numpy(ssm), torch.from_numpy(conv)
    got = tmamba.mamba_decode(_to_torch(jp), torch.from_numpy(x), jcfg, tssm, tconv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(tssm.numpy(), ssm)  # the caller's state is left as it was


def test_mamba_init_matches_the_reference_tree():
    jcfg = jconfigs.get_config("zamba2-7b").reduced()
    jp = jax.tree.map(np.asarray, jmamba.mamba_init(jax.random.PRNGKey(0), jcfg))
    tp = tmamba.mamba_init(torch.Generator().manual_seed(0), jcfg, stack=(3,))
    shapes = {k: (v["scale"] if isinstance(v, dict) else v).shape for k, v in jp.items()}
    assert {k: tuple((v["scale"] if isinstance(v, dict) else v).shape)
            for k, v in tp.items()} == {k: (3, *s) for k, s in shapes.items()}
    assert torch.equal(tp["D"], torch.ones_like(tp["D"]))
    np.testing.assert_allclose(float(tp["conv_w"].std()), 0.1, rtol=0.2)
