"""The hand kernels on the card, against their plain versions on the same
inputs.  Marked ``cuda``; each test skips, with its reason, on a host with no
CUDA device.  Run on the card with ``python -m pytest -m cuda tests``."""
import numpy as np
import pytest
import torch

from repro_torch.core import probes
from repro_torch.core.pchase import single_cycle_permutation
from repro_torch.core.timing import time_fn
from repro_torch.kernels import _util, ref
from repro_torch.kernels import api as tapi

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(shape, dev, dtype=torch.float32, seed=0, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("n,steps", [(8, 5), (1000, 777), (1 << 16, 1 << 12)])
def test_pchase_kernel(dev, n, steps):
    perm = torch.from_numpy(single_cycle_permutation(n, seed=n)).to(dev)
    before = _util.launch_counts().get("pchase", 0)
    got = tapi.pchase(perm, steps)
    torch.cuda.synchronize()
    assert _util.launch_counts()["pchase"] == before + 1
    assert int(got[0, 0]) == int(ref.pchase_ref(perm, steps)) == int(tapi.pchase(perm, steps, backend="torch")[0, 0])


@pytest.mark.parametrize("shape", [(8, 512), (24, 1000), (4096, 512), (8, 4)])
def test_stream_reduce_kernel(dev, shape):
    x = _rand(shape, dev)
    got = tapi.stream_reduce(x, block_cols=shape[1])
    want = ref.reduce_ref(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    ones = torch.ones(shape, device=dev)
    assert float(tapi.stream_reduce(ones, block_cols=shape[1])[0, 0]) == ones.numel()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-3)])
@pytest.mark.parametrize("vec_bytes", [4, 8, 16])
@pytest.mark.parametrize("shape,block_cols", [((8, 128), 128), ((64, 1024), 512)])
def test_axpy_kernel(dev, dtype, tol, vec_bytes, shape, block_cols):
    x, y = _rand(shape, dev, dtype, 1), _rand(shape, dev, dtype, 2)
    got = tapi.axpy(x, y, 2.5, block_cols=block_cols, vec_bytes=vec_bytes)
    torch.testing.assert_close(got, ref.axpy_ref(x, y, 2.5), rtol=tol, atol=tol)


@pytest.mark.parametrize("mkn", [(128, 128, 128), (300, 200, 100), (129, 7, 65), (512, 256, 384)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2),
                                       (torch.float16, 3e-2)])
def test_matmul_kernel(dev, mkn, dtype, tol):
    m, k, n = mkn
    a, b = _rand((m, k), dev, dtype, 3, 0.3), _rand((k, n), dev, dtype, 4, 0.3)
    want = ref.matmul_ref(a, b)
    for got in (tapi.matmul(a, b), tapi.matmul(a, b, bm=64, bk=32, bn=64)):
        assert got.shape == (m, n) and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_dispatch_on_the_card(dev):
    x = _rand((8, 512), dev)
    assert tapi.resolve_backend(device=x.device) == "cuda"
    with pytest.raises(NotImplementedError, match="no CUDA kernel yet"):
        tapi.stream_copy(x)
    torch.testing.assert_close(tapi.stream_copy(x, backend="torch"), x)
    with pytest.raises(ValueError, match="cpu clock"):
        time_fn(lambda t: t, x, device="cpu")


def test_probes_default_to_the_kernels(dev):
    _util.reset_launch_counts()
    res = probes.probe_pointer_chase([1 << 12, 1 << 20], steps=256, device=dev)
    assert res.meta["backend"] == "cuda" and all(np.isfinite(res.y))
    res = probes.probe_stream_bandwidth([1 << 20], device=dev)
    assert res.meta["backend"] == "cuda" and res.y[0] > 0
    res = probes.probe_matmul_throughput(sizes=(256,), device=dev)
    assert res.meta["backend"] == "cuda" and res.y[0] > 0
    counts = _util.launch_counts()
    assert all(counts.get(k, 0) > 0 for k in ("pchase", "stream_reduce", "matmul"))
