"""Port kernel layer against the reference: the same numpy inputs go through
``repro.kernels.api`` (Pallas in interpret mode, as tests/test_kernels.py
runs it) and through ``repro_torch.kernels`` on the CPU, where each kernel
wrapper takes its plain version.  Tolerances are the reference tests' own:
fp32 1e-4 for matmul and reduce, 1e-5 for axpy; bf16 2e-2 for axpy and 3e-2
for matmul; exact for pchase and copy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pchase import single_cycle_permutation
from repro.kernels import api as japi
from repro.kernels import ref as jref
from repro_torch.kernels import api as tapi
from repro_torch.kernels import ref as tref
from repro_torch.kernels.axpy import axpy_cuda
from repro_torch.kernels.matmul import matmul_cuda
from repro_torch.kernels.membw import stream_copy, stream_reduce, strided_reduce
from repro_torch.kernels.pchase import pchase_cuda

BF16 = np.dtype("bfloat16")


def _np(shape, seed, dtype=np.float32, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(dtype)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch on the CPU, bit-exact."""
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# per kernel module, against repro.kernels.api
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [64, 1000, 4096])
@pytest.mark.parametrize("steps", [10, 777])
def test_pchase_parity(n, steps):
    perm = single_cycle_permutation(n, seed=n)
    want = int(japi.pchase(jnp.asarray(perm), steps)[0, 0])
    tp = _t(perm)
    for got in (pchase_cuda(tp, steps), tapi.pchase(tp, steps)):
        assert got.shape == (1, 1) and got.dtype == torch.int32
        assert int(got[0, 0]) == want == tref.pchase_ref(tp, steps)


@pytest.mark.parametrize("shape,block_cols", [((8, 512), 512), ((64, 512), 512),
                                              ((24, 1000), 200)])
def test_stream_reduce_parity(shape, block_cols):
    x = _np(shape, 1)
    want = float(japi.stream_reduce(jnp.asarray(x), block_cols=block_cols)[0, 0])
    for got in (stream_reduce(_t(x), block_cols=block_cols), tapi.stream_reduce(_t(x))):
        assert got.shape == (1, 1) and got.dtype == torch.float32
        np.testing.assert_allclose(float(got[0, 0]), want, rtol=1e-4)


def test_stream_reduce_all_ones_exact():
    x = torch.ones((64, 512))
    assert float(tapi.stream_reduce(x)[0, 0]) == 64 * 512


@pytest.mark.parametrize("shape", [(8, 128), (64, 512), (32, 1024)])
@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_axpy_parity(shape, dtype):
    x, y = _np(shape, 2, dtype), _np(shape, 3, dtype)
    cols = min(shape[1], 512)
    want = japi.axpy(jnp.asarray(x), jnp.asarray(y), 2.5, block_rows=8, block_cols=cols)
    tol = 1e-5 if dtype == np.float32 else 2e-2
    for got in (axpy_cuda(_t(x), _t(y), 2.5, block_cols=cols), tapi.axpy(_t(x), _t(y), 2.5)):
        assert got.dtype == _t(x).dtype and got.shape == shape
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "mkn,tiles",
    [((128, 128, 128), {}), ((300, 200, 100), {}), ((96, 160, 64), {"bm": 32, "bk": 64, "bn": 32}),
     ((100, 70, 130), {"bm": 64, "bk": 32, "bn": 64})],
)
@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_matmul_parity(mkn, tiles, dtype):
    m, k, n = mkn
    a, b = _np((m, k), 4, dtype, 0.3), _np((k, n), 5, dtype, 0.3)
    want = japi.matmul(jnp.asarray(a), jnp.asarray(b), **tiles)
    tol = 1e-4 if dtype == np.float32 else 3e-2
    # the cuda impl carries the pad-and-slice; on CPU tensors its kernel
    # wrapper takes the plain version
    padded = tapi.matmul.impl("cuda")(_t(a), _t(b), **tiles)
    for got in (padded, matmul_cuda(_t(a), _t(b)), tapi.matmul(_t(a), _t(b))):
        assert got.shape == (m, n) and got.dtype == _t(a).dtype
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_matmul_out_dtype():
    a, b = _np((64, 32), 6), _np((32, 48), 7)
    got = matmul_cuda(_t(a), _t(b), out_dtype=torch.bfloat16)
    want = jref.matmul_ref(jnp.asarray(a), jnp.asarray(b), jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int32])
def test_stream_copy_kernel_parity(dtype):
    x = (np.arange(24 * 1024) % 251).reshape(24, 1024).astype(dtype)
    want = japi.stream_copy(jnp.asarray(x), block_rows=8, block_cols=512)  # Pallas, interpret
    got = stream_copy(_t(x), block_rows=8, block_cols=512)
    assert got.dtype == _t(x).dtype
    np.testing.assert_array_equal(_f32(got), _f32(want))


# x = arange(256*128) % 97, block_rows 64: the reference's Pallas kernel and
# its oracle, both run on the CPU (interpret mode), give these sums
_STRIDED_SUMS = {2: (785828.0, 785828.0), 3: (542504.0, 531453.0), 128: (23527.0, 10836.0)}


@pytest.mark.parametrize("stride", [2, 3, 128])
def test_strided_reduce_blocked_matches_the_pallas_kernel(stride):
    x = (np.arange(256 * 128) % 97).reshape(256, 128).astype(np.float32)
    kernel = float(japi.strided_reduce(jnp.asarray(x), stride=stride, block_rows=64)[0, 0])
    oracle = float(jref.strided_reduce_ref(jnp.asarray(x), stride)[0, 0])
    assert (kernel, oracle) == _STRIDED_SUMS[stride]
    # the port's kernel wrapper and its plain version sum what the Pallas kernel sums ...
    for got in (strided_reduce(_t(x), stride=stride, block_rows=64),
                tref.strided_reduce_blocked_ref(_t(x), stride, 64)):
        np.testing.assert_allclose(float(got[0, 0]), kernel, rtol=1e-6)
    # ... and the torch backend stays the counterpart of the reference's oracle
    got = tapi.strided_reduce(_t(x), stride=stride)
    np.testing.assert_allclose(float(got[0, 0]), oracle, rtol=1e-6)


# ---------------------------------------------------------------------------
# plain versions against repro.kernels.ref
# ---------------------------------------------------------------------------
def test_stream_copy_parity():
    x = _np((16, 512), 8)
    got = stream_copy(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.copy_ref(jnp.asarray(x))))
    np.testing.assert_array_equal(tapi.stream_copy(_t(x)).numpy(), x)


@pytest.mark.parametrize("stride", [1, 2, 4, 8])
def test_strided_reduce_parity(stride):
    x = _np((256, 128), 9)
    want = float(jref.strided_reduce_ref(jnp.asarray(x), stride)[0, 0])
    for got in (strided_reduce(_t(x), stride=stride), tapi.strided_reduce(_t(x), stride=stride)):
        np.testing.assert_allclose(float(got[0, 0]), want, rtol=1e-4)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0), (True, 16)])
def test_flash_attention_parity(causal, q_offset):
    q, k, v = (_np((2, 48, 2, 32), s, scale=0.5) for s in (10, 11, 12))
    want = japi.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, q_offset=q_offset, backend="xla")
    got = tapi.flash_attention(_t(q), _t(k), _t(v), causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=5e-5, atol=5e-5)
    flat = [x.transpose(0, 2, 1, 3).reshape(4, 48, 32) for x in (q, k, v)]
    want_flat = jref.flash_attention_ref(*map(jnp.asarray, flat), causal=causal,
                                         q_offset=q_offset)
    got_flat = tref.flash_attention_ref(*map(_t, flat), causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(_f32(got_flat), _f32(want_flat), rtol=5e-5, atol=5e-5)


def test_ssm_scan_parity():
    bsz, s, h, p, n = 2, 40, 3, 8, 4
    u = _np((bsz, s, h, p), 13)
    a = -np.abs(_np((bsz, s, h), 14)) * 0.2
    b, c = _np((bsz, s, n), 15), _np((bsz, s, n), 16)
    want = japi.ssm_scan(*map(jnp.asarray, (u, a, b, c)), backend="xla")
    got = tapi.ssm_scan(*map(_t, (u, a, b, c)))
    assert got.shape == (bsz, s, h, p)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------
def test_backend_follows_tensor_and_cuda_on_cpu_raises():
    x = _t(_np((8, 512), 17))
    assert tapi.resolve_backend(device=x.device) == "torch"
    assert tapi.default_backend("cuda") == "cuda"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tapi.stream_reduce(x, backend="cuda")
    with tapi.kernel_policy(backend="cuda"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tapi.axpy(x, x, 2.0)
    with pytest.raises(ValueError, match="unknown backend"):
        tapi.stream_reduce(x, backend="pallas")


@pytest.mark.parametrize("op", ["stream_copy", "strided_reduce", "flash_attention", "ssm_scan"])
def test_op_without_kernel_raises_on_cuda(op):
    """Asking for the cuda backend never falls back: every op has a kernel,
    and asking for it on CPU tensors raises."""
    assert tapi.get_op(op).impl("cuda") is not None
    x = torch.ones((64, 512))
    args = {"stream_copy": (x,), "strided_reduce": (x,),
            "flash_attention": (torch.ones((1, 8, 2, 64)),) * 3,
            "ssm_scan": (torch.ones((1, 8, 2, 4)), -torch.ones((1, 8, 2)), torch.ones((1, 8, 3)),
                         torch.ones((1, 8, 3)))}[op]
    kw = {"stride": 2} if op == "strided_reduce" else {}
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tapi.get_op(op)(*args, backend="cuda", **kw)


def test_policy_rejects_unported_features_and_bad_tiles():
    with tapi.kernel_policy(autotune=True) as pol:  # ported: autotune resolves tiles
        assert pol.autotune
    with tapi.kernel_policy(guard="shadow") as pol:  # ported: the numerics guard
        assert pol.guard == "shadow"
    with pytest.raises(ValueError, match="guard mode"):
        with tapi.kernel_policy(guard="paranoid"):
            pass
    with pytest.raises(ValueError, match="unknown op"):
        with tapi.kernel_policy(tiles={"nope": {"bm": 1}}):
            pass
    with pytest.raises(ValueError, match="no tile kwarg"):
        with tapi.kernel_policy(tiles={"matmul": {"block_rows": 8}}):
            pass
    with tapi.kernel_policy(tiles={"matmul": {"bm": 32}}):
        with tapi.kernel_policy(tiles={"matmul": {"bn": 16}}, backend="torch"):
            pol = tapi.current_policy()
            assert pol.tiles == {"matmul": {"bm": 32, "bn": 16}} and pol.backend == "torch"
    assert tapi.current_policy().tiles == {}
    x = _t(_np((8, 8), 18))
    with pytest.raises(TypeError, match="unexpected keyword"):
        tapi.matmul(x, x, bogus=1)


def test_wrappers_check_their_inputs():
    with pytest.raises(TypeError, match="matmul takes"):  # int8 and fp8 run since the gemm_lp slice
        matmul_cuda(torch.ones((8, 8), dtype=torch.int16), torch.ones((8, 8), dtype=torch.int16))
    with pytest.raises(ValueError, match="vec_bytes"):
        axpy_cuda(torch.ones(8, 512), torch.ones(8, 512), 1.0, vec_bytes=32)
    with pytest.raises(ValueError, match="tiles"):
        stream_reduce(torch.ones(8, 500))
    with pytest.raises(TypeError, match="int32"):
        pchase_cuda(torch.arange(8, dtype=torch.int64), 3)
    assert set(tapi.op_names()) == set(japi.op_names())
