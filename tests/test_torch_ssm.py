"""The port's SSD scan and Mamba2 block against the reference on the CPU.

The same numpy inputs go through ``repro`` (the Pallas ``_ssd_kernel`` in
interpret mode, as the reference's tests run it, or its ``xla`` oracle) and
through ``repro_torch``: the ``ssm_scan`` op's ``torch`` backend (the
sequential recurrence), its ``cuda`` implementation called on CPU tensors
(the wrapper's chunk clamp, padding and slicing around the kernel's plain
version, ``ref.ssm_scan_chunked_ref``), the kernel's three plain passes
(``ref.ssd_chunk_states``, ``ssd_pass_states``, ``ssd_chunk_outputs``) on
their own and composed, the model-level ``ssd_chunked`` (folded onto them)
and the Mamba2 block.  Tolerances: float32 throughout; 2e-4 for the scan
against the Pallas kernel (a different summation order over up to 128 steps,
the reference tests' own), 1e-5 for the chunked plain versions against the
Pallas kernel (the same chunked arithmetic), 1e-4 for the model functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import api as japi
from repro.kernels import guard
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro.models import mamba as jmamba
from repro_torch import configs as tconfigs
from repro_torch.kernels import _util
from repro_torch.kernels import api as tapi
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan as tssd
from repro_torch.kernels.ssm_scan import ssm_scan_cuda
from repro_torch.models import mamba as tmamba

# fp32 parity at the reference's own tolerance for the card (256 ulps: 3.05e-5)
_F32_TOL = guard.tolerance(np.float32, "nvidia-h100-sxm")
TOL = dict(rtol=_F32_TOL.rtol, atol=_F32_TOL.atol)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _scan_inputs(bsz, s, h, p, n, seed):
    u = _np((bsz, s, h, p), seed)
    a = -np.abs(_np((bsz, s, h), seed + 1)) * 0.2
    return u, a, _np((bsz, s, n), seed + 2), _np((bsz, s, n), seed + 3)


# a_log = -softplus(N(shift, 1)) a step, as the card's checks draw it: shift 0
# is the init's fast decay (~0.8 a step), -5 a slow one (~0.007), under which
# the state passed between the chunks decides y
DECAY_SHIFT = {"fast": 0.0, "slow": -5.0}


def _decay_inputs(bsz, s, h, p, n, seed, decay):
    u, _, b, c = _scan_inputs(bsz, s, h, p, n, seed)
    a = -np.logaddexp(0.0, _np((bsz, s, h), seed + 1) + DECAY_SHIFT[decay]).astype(np.float32)
    return u, a, b, c


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


@pytest.mark.parametrize("s,p,n,chunk", [
    (1024, 8, 4, 512), (512, 192, 8, 256), (512, 8, 192, 256), (512, 130, 129, 512),
])
def test_ssm_scan_past_the_old_limits_matches_the_pallas_kernel(s, p, n, chunk):
    """Chunks past 256 and P or N past 128 compute in the reference's kernel
    and in the port's cuda wrapper (here its plain version): rtol 2e-4 as
    the other chunked-scan parity test, atol 2e-5 of max |y| for the fp32
    sums of up to 512 steps taken in another order."""
    ins = _scan_inputs(1, s, 2, p, n, seed=s + p + n)
    want = japi.ssm_scan(*map(jnp.asarray, ins), chunk=chunk, backend="pallas")
    t = [torch.from_numpy(x) for x in ins]
    got = tapi.ssm_scan.impl("cuda")(*t, chunk=chunk)
    assert got.shape == (1, s, 2, p)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("kwargs", [dict(chunk=512), dict(p=130), dict(n=129)])
def test_kernel_wrapper_takes_shapes_past_the_old_limits(kwargs):
    """chunk 512, P 130 and N 129 were refused; now they run, equal to the
    chunked plain version."""
    p, n, s = kwargs.get("p", 8), kwargs.get("n", 4), 512
    t = [torch.from_numpy(x) for x in _scan_inputs(1, s, 2, p, n, seed=p + n)]
    chunk = kwargs.get("chunk", 256)
    want = tref.ssm_scan_chunked_ref(*_util.flatten_ssm(*t), chunk)
    assert torch.equal(ssm_scan_cuda(*t, chunk=chunk), _util.unflatten_heads(want, 1))


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(chunk=20), ValueError, "divide"),
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


# ---------------------------------------------------------------------------
# the wgmma route's plain passes, and the route choice
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("chunk", [16, 40, 256])
def test_ssd_passes_compose_to_the_pallas_kernel(chunk, decay):
    """ref's three passes composed (ssd_chunked_ref on the model layout, B and
    C shared by the heads) against ssm_scan_pallas in interpret mode over 3
    chunks: rtol 1e-5 and atol 1e-5 of max |y| (the same chunked fp32
    arithmetic, summed in another order)."""
    bsz, h, p, n = 1, 2, 8, 4
    ins = [torch.from_numpy(x) for x in _decay_inputs(bsz, 3 * chunk, h, p, n, chunk, decay)]
    flat = [np.asarray(x) for x in _util.flatten_ssm(*ins)]
    want = np.asarray(ssm_scan_pallas(*map(jnp.asarray, flat), chunk=chunk, interpret=True))
    y, _ = tref.ssd_chunked_ref(*ins, chunk)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(_util.flatten_heads(y).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("chunk", [16, 40])
def test_passed_states_are_the_reference_final_states(chunk, decay):
    """ssd_pass_states' state after the last chunk is the reference
    ssd_chunked's h_final from a zero state, and the state it passes into
    chunk c is h_final of the first c chunks."""
    bsz, h, p, n = 2, 3, 8, 4
    u, a, b, c = _decay_inputs(bsz, 3 * chunk, h, p, n, chunk + 1, decay)
    states, acum = tref.ssd_chunk_states(*map(torch.from_numpy, (u, a, b)), chunk)
    assert states.shape == (bsz, h, 3, p, n) and acum.shape == (bsz, h, 3 * chunk)
    entering, h_final = tref.ssd_pass_states(states, acum, chunk)
    h0 = np.zeros((bsz, h, p, n), np.float32)
    for steps, got in ((3 * chunk, h_final), (chunk, entering[:, :, 1]),
                       (2 * chunk, entering[:, :, 2])):
        _, want = jmamba.ssd_chunked(*(jnp.asarray(x[:, :steps]) for x in (u, a, b, c)),
                                     jnp.asarray(h0), chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not entering[:, :, 0].any()


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(40, 16), (100, 40), (48, 16)])
def test_folded_ssd_chunked_matches_the_reference(s, chunk, with_h0):
    """models/mamba.py::ssd_chunked (the plain passes around S padded to the
    chunk) against the reference's, from a zero state and from h0."""
    bsz, h, p, n = 2, 3, 8, 4
    u, a, b, c = _decay_inputs(bsz, s, h, p, n, s + chunk, "slow")
    h0 = _np((bsz, h, p, n), 31) if with_h0 else np.zeros((bsz, h, p, n), np.float32)
    want_y, want_h = jmamba.ssd_chunked(*map(jnp.asarray, (u, a, b, c, h0)), chunk)
    got_y, got_h = tmamba.ssd_chunked(*map(torch.from_numpy, (u, a, b, c, h0)), chunk)
    assert got_y.shape == (bsz, s, h, p)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


def test_pass_wrappers_on_cpu_tensors_compose_to_the_scan():
    """The wgmma route's per-pass wrappers take their plain versions on CPU
    tensors: composed, they give ssm_scan_cuda's y (pass 2 on the CPU
    returns a new tensor, on the card it rewrites its input)."""
    ins = [torch.from_numpy(x) for x in _decay_inputs(2, 96, 3, 16, 32, 7, "slow")]
    u, a, b, c = ins
    states, acum = tssd.ssd_chunk_states_cuda(u, a, b, chunk=32)
    entering = tssd.ssd_pass_states_cuda(states, acum, chunk=32)
    got = tssd.ssd_chunk_outputs_cuda(u, b, c, entering, acum, chunk=32)
    np.testing.assert_allclose(got.numpy(), ssm_scan_cuda(*ins, chunk=32).numpy(), **TOL)
    with pytest.raises(ValueError, match="does not match"):
        tssd.ssd_pass_states_cuda(states, acum[:, :, :64], chunk=32)


@pytest.mark.parametrize("dtype,p,n,want", [
    (torch.bfloat16, 64, 64, True), (torch.float16, 16, 128, False), (torch.bfloat16, 80, 48, True),
    (torch.float32, 64, 64, False), (torch.bfloat16, 192, 16, False),
    (torch.bfloat16, 64, 300, False), (torch.bfloat16, 8, 4, False),
    (torch.float16, 64, 24, False), (torch.bfloat16, 144, 64, False),
])
def test_tc_route_takes_16_bit_widths_up_to_128(dtype, p, n, want):
    """bf16 with P and N multiples of 16 up to 128 goes to the wgmma kernel;
    fp32, fp16 (whose state would overflow in the wgmma route's fp16 hi + lo
    pairs) and every other width stay on the SIMT one."""
    assert tssd.tc_route(dtype, p, n) is want


def test_fp16_state_case_overflows_fp16_in_the_state_only():
    """The card's fp16 case (``test_torch_cuda.fp16_state_case``) does what it
    is meant to on the CPU: the state passes 65,504, y stays inside it, and
    the scan takes the SIMT route, whose state is fp32.  The reference's
    kernel (interpret mode) on the same fp16 inputs keeps its fp32 state, and
    it and the wrapper's plain version agree with the fp32 scan within
    fp16's limit."""
    from test_torch_cuda import _SSM_TOL, fp16_state_case

    chunk = 256
    u, a, b, c = fp16_state_case("cpu")
    states, acum = tref.ssd_chunk_states(u.float(), a, b.float(), chunk)
    entering, _ = tref.ssd_pass_states(states, acum, chunk)
    want = ssm_scan_cuda(u.float(), a, b.float(), c.float(), chunk=chunk)
    assert float(entering.abs().max()) > 65504 > float(want.abs().max())
    assert not tssd.tc_route(u.dtype, u.shape[-1], b.shape[-1])
    jax_y = japi.ssm_scan(*(jnp.asarray(t.numpy()) for t in (u, a, b, c)), chunk=chunk,
                          backend="pallas")
    tol = dict(_SSM_TOL)[torch.float16]
    for got in (ssm_scan_cuda(u, a, b, c, chunk=chunk), torch.tensor(np.asarray(jax_y))):
        assert got.dtype == torch.float16
        torch.testing.assert_close(got.float(), want, rtol=tol,
                                   atol=tol * float(want.abs().max()))
