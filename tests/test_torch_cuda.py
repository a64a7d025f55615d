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
from repro_torch.kernels.axpy import axpy_geometry
from repro_torch.kernels.matmul import matmul_cuda
from repro_torch.kernels.membw import COPY_BLOCKS_PER_SM, COPY_ROUND_BYTES

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-3)])
@pytest.mark.parametrize("vec_bytes", [4, 8, 16])
@pytest.mark.parametrize("row_vecs,block_rows", [(13, 3), (1501, 3), (7, 5)])
def test_axpy_kernel_partial_rounds(dev, dtype, tol, vec_bytes, row_vecs, block_rows):
    """Tiles of an odd number of vectors, so never a multiple of the unroll:
    39 and 35 vectors take one masked round of one warp, 4503 take two rounds
    of 1024 threads, the second partial; 2 x 2 tiles, so the offsets of every
    tile but the first are exercised too."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    block_cols = row_vecs * vec_bytes // itemsize
    shape = (2 * block_rows, 2 * block_cols)
    geo = axpy_geometry(shape, block_rows, block_cols, vec_bytes, itemsize)
    assert (block_rows * row_vecs) % geo.unroll
    x, y = _rand(shape, dev, dtype, 1), _rand(shape, dev, dtype, 2)
    got = tapi.axpy(x, y, 2.5, block_rows=block_rows, block_cols=block_cols, vec_bytes=vec_bytes)
    torch.testing.assert_close(got, ref.axpy_ref(x, y, 2.5), rtol=tol, atol=tol)


def test_axpy_kernel_refuses_a_geometry_short_of_the_tile(dev):
    from repro_torch.kernels import axpy as kaxpy

    x = _rand((8, 512), dev)
    out = torch.empty_like(x)
    geo = axpy_geometry(x.shape, 8, 512, 16, 4)
    for threads, rounds in ((geo.threads, geo.rounds - 1), (geo.threads // 2, geo.rounds)):
        with pytest.raises(RuntimeError, match="axpy kernel launch failed"):
            _util.launch("axpy", "repro_axpy", kaxpy._ARGTYPES, x.device, 0, 16, 1.0,
                         x.data_ptr(), x.data_ptr(), out.data_ptr(), 8, 512, 8, 512, threads,
                         rounds)


def test_axpy_kernel_unroll_is_the_geometrys_at_every_width(dev):
    """The built kernel reports one unroll for every access width, the one
    axpy_geometry plans with."""
    from repro_torch.kernels.axpy import VEC_BYTES, kernel_unroll

    planned = axpy_geometry((8, 512), 8, 512, 16, 4).unroll
    assert {kernel_unroll(vb) for vb in VEC_BYTES} == {planned}
    assert kernel_unroll(2) == 0


@pytest.mark.parametrize("mkn", [(128, 128, 128), (300, 200, 100), (129, 7, 65), (512, 256, 384),
                                 (256, 1000, 192), (2048, 2048, 2048)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2),
                                       (torch.float16, 3e-2)])
def test_matmul_kernel(dev, mkn, dtype, tol):
    """Through the op (which pads to its tiles) and the kernel's own wrapper on
    the unpadded operands.  K 1000 leaves a partial last stage of the 16-deep
    ring; 129 x 7 x 65 has rows that are not 16-byte aligned (the one-element
    instance); N 100, 7 and 384 end inside the kernel's 256-wide tile."""
    m, k, n = mkn
    a, b = _rand((m, k), dev, dtype, 3, 0.3), _rand((k, n), dev, dtype, 4, 0.3)
    want = ref.matmul_ref(a, b)
    for got in (tapi.matmul(a, b), tapi.matmul(a, b, bm=64, bk=32, bn=64), matmul_cuda(a, b)):
        assert got.shape == (m, n) and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_dispatch_on_the_card(dev):
    x = _rand((8, 512), dev)
    assert tapi.resolve_backend(device=x.device) == "cuda"
    u = _rand((1, 8, 2, 4), dev)
    a, bc = -_rand((1, 8, 2), dev).abs(), _rand((1, 8, 3), dev)
    before = _util.launch_counts().get("ssm_scan", 0)
    got = tapi.ssm_scan(u, a, bc, bc)
    torch.cuda.synchronize()
    assert _util.launch_counts()["ssm_scan"] == before + 1
    torch.testing.assert_close(got, tapi.ssm_scan(u, a, bc, bc, backend="torch"), rtol=1e-4,
                               atol=1e-4)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("shape,block_cols", [((8, 512), 512), ((24, 1000), 200), ((1, 4), 4)])
def test_stream_copy_kernel(dev, dtype, shape, block_cols):
    x = _rand(shape, dev, scale=100.0).to(dtype)
    before = _util.launch_counts().get("stream_copy", 0)
    got = tapi.stream_copy(x, block_rows=shape[0], block_cols=block_cols)
    torch.cuda.synchronize()
    assert _util.launch_counts()["stream_copy"] == before + 1
    assert got.data_ptr() != x.data_ptr() and torch.equal(got, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("rounds,extra", [
    (0, COPY_ROUND_BYTES - 48),  # below one round
    (3, 0), (300, 0),  # whole rounds, one a block
    (3, 16), (300, 16),  # and 16 bytes more: a partial round
    (3, "short"), (300, "short"),  # and a tail of fewer than 16 bytes
    ("grid", 16), ("grid", "short"),  # two grid strides and a few rounds more
])
def test_stream_copy_round_edges(dev, dtype, rounds, extra):
    """Sizes at the edges of the copy's rounds; a short tail is 12 bytes of
    4-byte elements or 10 of bf16, copied by threads after the whole 16s.
    "grid" takes every block round three times, the last time partially."""
    item = torch.tensor([], dtype=dtype).element_size()
    if rounds == "grid":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rounds = 2 * COPY_BLOCKS_PER_SM * sms + 5
    if extra == "short":
        extra = 12 if item == 4 else 10
    n = (rounds * COPY_ROUND_BYTES + extra) // item
    x = _rand((1, n), dev, scale=100.0).to(dtype)
    got = tapi.stream_copy(x, block_rows=1, block_cols=n)
    torch.cuda.synchronize()
    assert torch.equal(got, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_stream_copy_writes_nothing_past_the_end(dev, dtype):
    """x is a view at the start of a larger storage of other values, and the
    output the start of a larger buffer of a guard pattern: a kernel that
    copied past the tensor's last byte would change the guard."""
    from repro_torch.kernels import membw

    item = torch.tensor([], dtype=dtype).element_size()
    n = (3 * COPY_ROUND_BYTES + 16 + 12) // item  # a partial round and a 12-byte tail
    src = _rand((n + 4096,), dev, scale=100.0).to(dtype)
    x = src[:n].view(1, n)
    guard = torch.full((n + 4096,), 77, dtype=dtype, device=dev)
    plan = membw.copy_plan(n * item, torch.cuda.get_device_properties(dev).multi_processor_count)
    _util.launch("stream_copy", "repro_stream_copy", membw._COPY_ARGTYPES, x.device,
                 x.data_ptr(), n * item, guard.data_ptr(), plan.ctas, plan.threads)
    torch.cuda.synchronize()
    assert torch.equal(guard[:n], src[:n])
    assert bool((guard[n:] == 77).all())
    assert torch.equal(tapi.stream_copy(x, block_rows=1, block_cols=n), x)


@pytest.mark.parametrize("stride", [1, 2, 3, 8, 64, 128])
@pytest.mark.parametrize("shape", [(256, 128), (4096, 512), (128, 6)])
def test_strided_reduce_kernel(dev, stride, shape):
    x = _rand(shape, dev)
    got = tapi.strided_reduce(x, stride=stride, block_rows=64)
    want = ref.strided_reduce_blocked_ref(x, stride, 64)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if 64 % stride == 0:  # then the reference's oracle sums the same rows
        torch.testing.assert_close(got, ref.strided_reduce_ref(x, stride), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
@pytest.mark.parametrize("hd", [16, 64, 112, 128, 256])  # fp32 zero-pads 16 and 112
@pytest.mark.parametrize("h,hkv", [(3, 3), (4, 1), (4, 2), (8, 1)])
@pytest.mark.parametrize("b,causal,sq,skv,q_offset,tiles", [
    (2, True, 200, 200, 0, {"bk": 1024}),
    (2, False, 64, 100, 0, {"bq": 32, "bk": 50}),
    (2, True, 33, 97, 64, {"bq": 16, "bk": 32}),
    (1, True, 256, 256, 0, {}),  # B == 1: the head flattening is a view, not a copy
    (3, True, 300, 300, 0, {}),  # S a multiple of neither 64 nor 128
    (1, False, 130, 70, 0, {}),
])
def test_flash_attention_kernel(dev, dtype, tol, hd, h, hkv, b, causal, sq, skv, q_offset, tiles):
    """Against the plain version; grouped KV heads (H over Hkv) reach the
    bf16/fp16 kernel unexpanded, in the model layout."""
    q = _rand((b, sq, h, hd), dev, dtype, 5)
    k = _rand((b, skv, hkv, hd), dev, dtype, 6)
    v = _rand((b, skv, hkv, hd), dev, dtype, 7)
    before = _util.launch_counts().get("flash_attention", 0)
    got = tapi.flash_attention(q, k, v, causal=causal, q_offset=q_offset, **tiles)
    torch.cuda.synchronize()
    assert _util.launch_counts()["flash_attention"] == before + 1
    want = tapi.flash_attention(q, k, v, causal=causal, q_offset=q_offset, backend="torch")
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", [64, 112, 256])
def test_flash_attention_running_max_and_masked_tiles(dev, dtype, hd):
    """Scores that grow along the keys raise every row's running max on every
    key tile, so each tile rescales the accumulator (corr < 1).  Causal at S
    384 from q_offset 0: the first 64 rows of each block see none of the
    block's later key tiles (a warpgroup skips them) and the diagonal tiles are
    partly masked.  And keys past kv_len: the head-flattened entry point with
    a garbage tail.  Tolerance 2e-2, one rounding of p to the input type."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    b, s, h = 2, 384, 4
    ramp = torch.linspace(0.0, 3.0, s, device=dev)[None, :, None, None]
    q = (0.5 + 0.1 * _rand((b, s, h, hd), dev, seed=8)).to(dtype)
    k = (ramp * (1.0 + 0.1 * _rand((b, s, 1, hd), dev, seed=9)) * hd ** -0.5 * 4).to(dtype)
    v = _rand((b, s, 1, hd), dev, dtype, 10)
    before = _util.launch_counts().get("flash_attention", 0)
    got = tapi.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _util.launch_counts()["flash_attention"] == before + 1
    want = tapi.flash_attention(q, k, v, causal=True, backend="torch")
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)

    qf, kf, vf = (t.permute(0, 2, 1, 3).reshape(-1, s, hd).contiguous()
                  for t in (q, k.expand(b, s, h, hd), v.expand(b, s, h, hd)))
    kv_len = 300
    kf[:, kv_len:], vf[:, kv_len:] = 1e4, 1e4  # must not leak in
    got = flash_attention_cuda(qf, kf, vf, causal=False, bq=128, bk=128, kv_len=kv_len)
    want = ref.flash_attention_ref(qf, kf[:, :kv_len], vf[:, :kv_len], causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", [12, 100])
def test_flash_attention_pads_a_head_width_off_the_tma_unit(dev, dtype, hd):
    """A 16-bit row of hd that is not a multiple of 16 bytes: zero-padded in
    the model layout (grouped KV heads unexpanded), one launch, sliced back."""
    q = _rand((2, 150, 4, hd), dev, dtype, 11)
    k = _rand((2, 150, 2, hd), dev, dtype, 12)
    v = _rand((2, 150, 2, hd), dev, dtype, 13)
    before = _util.launch_counts().get("flash_attention", 0)
    got = tapi.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _util.launch_counts()["flash_attention"] == before + 1
    want = tapi.flash_attention(q, k, v, causal=True, backend="torch")
    assert got.shape == want.shape == (2, 150, 4, hd) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_lm_prefill_runs_the_flash_kernel(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("gemma-2b").reduced().replace(head_dim=64, attn_impl="pallas")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    _util.reset_launch_counts()
    last, cache = model.prefill(params, {"tokens": toks}, 48)
    assert _util.launch_counts() == {"flash_attention": cfg.n_layers}
    plain, _ = build_model(cfg.replace(attn_impl="blockwise"), device=dev).prefill(
        params, {"tokens": toks}, 48)
    torch.testing.assert_close(last, plain, rtol=1e-4, atol=1e-4)


# -softplus(N(shift, 1)) per step: shift 0 is the init's ~0.8, under which
# exp(acum) is below 1e-20 within ~60 steps; shift -5 is ~0.007, a trained
# model's slow decay, under which the carried state and the key tiles far below
# the diagonal decide y
DECAY_SHIFT = {"fast": 0.0, "slow": -5.0}


def _ssm_inputs(dev, dtype, bsz, s, h, p, n, seed, decay="fast"):
    u = _rand((bsz, s, h, p), dev, seed=seed, scale=0.5)
    a = -torch.nn.functional.softplus(_rand((bsz, s, h), dev, seed=seed + 1)
                                      + DECAY_SHIFT[decay])
    b = _rand((bsz, s, n), dev, seed=seed + 2, scale=0.5)
    c = _rand((bsz, s, n), dev, seed=seed + 3, scale=0.5)
    return u.to(dtype), a, b.to(dtype), c.to(dtype)


# ssm_scan's tolerances, relative to max |y|: fp32 sum order, or one rounding
# of y to the 16-bit type
_SSM_TOL = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-3)]


def _ssm_route(dtype, p, n):
    from repro_torch.kernels.ssm_scan import tc_route

    return "wgmma" if tc_route(dtype, p, n) else "simt"


@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("dtype,tol", _SSM_TOL)
@pytest.mark.parametrize("chunk", [16, 40, 64, 256])
@pytest.mark.parametrize("bsz,s,h,p,n", [(1, 300, 3, 16, 16), (2, 520, 2, 64, 64),
                                         (1, 100, 2, 8, 4), (1, 130, 1, 128, 128)])
def test_ssm_scan_kernel(dev, dtype, tol, chunk, bsz, s, h, p, n, decay):
    """Against the chunked plain version on the same (padded) inputs; S is a
    multiple of no chunk, so the op's wrapper pads.  bf16 takes the wgmma
    route but at P 8, N 4 (the SIMT kernel's, as fp32 and fp16).  The slow
    decay is what makes the state carry and the far key tiles count."""
    u, a, b, c = _ssm_inputs(dev, dtype, bsz, s, h, p, n, seed=chunk + s, decay=decay)
    before = _util.launch_counts().get("ssm_scan", 0)
    routes = _util.route_counts().get("ssm_scan", {})
    got = tapi.ssm_scan(u, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert _util.launch_counts()["ssm_scan"] == before + 1
    route = _ssm_route(dtype, p, n)
    assert _util.route_counts()["ssm_scan"][route] == routes.get(route, 0) + 1
    assert got.shape == u.shape and got.dtype == dtype
    fit = min(chunk, s)
    padded = [_util.pad_to_multiple(t, fit, 1) for t in (u, a, b, c)]
    want = ref.ssm_scan_chunked_ref(*_util.flatten_ssm(*padded), fit)
    want = _util.unflatten_heads(want, bsz)[:, :s].float()
    scale = float(want.abs().max())
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol * scale)
    if dtype == torch.float32:  # and the sequential recurrence, the torch backend
        torch.testing.assert_close(got, tapi.ssm_scan(u, a, b, c, backend="torch"), rtol=tol,
                                   atol=tol * scale)


def test_hybrid_forward_runs_both_kernels(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("zamba2-7b").reduced().replace(ssm_impl="pallas", attn_impl="pallas")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), device=dev, generator=g)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    _util.reset_launch_counts()
    loss = model.loss_fn(params, batch)
    assert _util.launch_counts() == {"ssm_scan": cfg.n_layers, "flash_attention": 2}
    plain = build_model(cfg.replace(ssm_impl="xla", attn_impl="blockwise"), device=dev)
    torch.testing.assert_close(loss, plain.loss_fn(params, batch), rtol=1e-4, atol=1e-4)
    _util.reset_launch_counts()
    last, _ = model.prefill(params, {"tokens": toks[:, :-1]}, 48)
    assert _util.launch_counts() == {"flash_attention": 2}
    want, _ = plain.prefill(params, {"tokens": toks[:, :-1]}, 48)
    torch.testing.assert_close(last, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the tensor-core matmul (bf16, fp16, int8, fp8 e4m3), the op-latency chains,
# and ssm_scan / flash_attention past their former shape limits
# ---------------------------------------------------------------------------
def _operands(dev, dtype, m, k, n, seed):
    if dtype == torch.int8:
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int32)
                .to(torch.int8) for shape in ((m, k), (k, n))]
    scale = 2.0 if dtype == torch.float8_e4m3fn else 1.0
    return [_rand(shape, dev, torch.float32, seed + i, scale).to(dtype)
            for i, shape in enumerate(((m, k), (k, n)))]


def _row_rel_err(got, want):
    g, w = got.double(), want.double()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-300)).max())


# each row's ||err|| / ||exact||: fp32 outputs carry the sum order (fp8: the
# tensor cores' ~14-bit accumulation within each 128 of K, ~1e-4);
# 16-bit outputs their own rounding (2^-9 bf16, 2^-12 fp16, bounds on a row's)
_ROW_LIMIT = {(torch.bfloat16, torch.float32): 1e-5, (torch.float16, torch.float32): 1e-5,
              (torch.float8_e4m3fn, torch.float32): 5e-4, "bfloat16": 4e-3, "float16": 5e-4}


@pytest.mark.parametrize("mkn", [(300, 200, 100), (129, 40, 72), (256, 1000, 192),
                                 (1024, 1024, 1024)])
@pytest.mark.parametrize("dtype,out", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16), (torch.float16, torch.float32),
    (torch.int8, torch.int32), (torch.int8, torch.int8), (torch.int8, torch.float32),
    (torch.float8_e4m3fn, torch.float32), (torch.float8_e4m3fn, torch.bfloat16),
    (torch.float8_e4m3fn, torch.float8_e4m3fn),
])
def test_matmul_tensor_core_kernel(dev, mkn, dtype, out):
    """Each tensor-core instance against the plain version (integers exact,
    saturation included) and the float64 product (each row's relative error);
    the 8-bit ones launch the transpose first.  The shapes end inside the
    128-wide tiles, and K 200 / 40 / 1000 inside a 64- or 128-deep one."""
    m, k, n = mkn
    a, b = _operands(dev, dtype, m, k, n, seed=m + k + n)
    counts = dict(_util.launch_counts())
    got = matmul_cuda(a, b, out_dtype=out)
    torch.cuda.synchronize()
    name = {torch.bfloat16: "matmul_bf16", torch.float16: "matmul_fp16",
            torch.int8: "matmul_int8", torch.float8_e4m3fn: "matmul_fp8"}[dtype]
    now = _util.launch_counts()
    assert now[name] == counts.get(name, 0) + 1
    if dtype.itemsize == 1:
        assert now["matmul_transpose"] == counts.get("matmul_transpose", 0) + 1
    assert got.shape == (m, n) and got.dtype == out
    want = ref.matmul_ref(a, b, out)
    exact = a.double() @ b.double()
    if dtype == torch.int8:  # every sum here stays below 2^24: exact in fp32 too
        assert torch.equal(got, want)
    elif out == torch.float8_e4m3fn:
        # NaN past 448's rounding range; a sum within 1e-3 of that line may go
        # either way, the kernel's and the plain version's fp32 sums differing
        sure = (exact.abs() - ref.FP8_E4M3_NAN_PAST).abs() > 1e-3 * ref.FP8_E4M3_NAN_PAST
        gf, wf = got.float(), want.float()
        assert torch.equal(torch.isnan(gf)[sure], torch.isnan(wf)[sure])
        fin = ~torch.isnan(gf) & ~torch.isnan(wf)
        torch.testing.assert_close(gf[fin], wf[fin], rtol=0.125, atol=0.125)
    else:
        limit = _ROW_LIMIT.get((dtype, out)) or _ROW_LIMIT[str(out).removeprefix("torch.")]
        assert _row_rel_err(got, exact) <= limit


def test_int8_kernel_accumulates_exactly_past_2_to_the_24(dev):
    """The s32 accumulator keeps 127 * 127 * 1152 + 1 (past 2^24, odd)
    exact, where the reference's fp32 accumulator, and the plain version,
    round it: the kept deviation of ROADMAP.md."""
    k = 1152
    a = torch.zeros((128, k + 128), dtype=torch.int8, device=dev)
    b = torch.zeros((k + 128, 128), dtype=torch.int8, device=dev)
    a[:, :k], b[:k] = 127, 127
    a[:, k], b[k] = 1, 1
    got = matmul_cuda(a, b, out_dtype=torch.int32)
    assert (got == 127 * 127 * k + 1).all()
    assert (ref.matmul_ref(a, b, torch.int32) != got).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("n", [100, 136, 1])
def test_matmul_tensor_core_writes_nothing_past_n(dev, dtype, n):
    """Through the C entry point into rows of n + 24 elements: the 24 past N
    keep their sentinel."""
    from repro_torch.kernels import matmul as mm

    m, k, pad = 200, 96, 24
    a, b = _operands(dev, dtype, m, k, n, seed=n)
    a = mm._tma_operand(a)
    b = mm.transpose8(b) if dtype.itemsize == 1 else mm._tma_operand(b)
    out = torch.full((m, n + pad), -7.0, device=dev)
    _util.launch(mm.TC_KERNELS[dtype], "repro_matmul_tc", mm._TC_ARGTYPES, dev,
                 _util.DTYPE_CODES[dtype], _util.DTYPE_CODES[torch.float32], a.data_ptr(),
                 b.data_ptr(), out.data_ptr(), m, n, k, a.shape[1], b.shape[1], n + pad)
    torch.cuda.synchronize()
    assert (out[:, n:] == -7.0).all()
    want = ref.matmul_ref(*_operands(dev, dtype, m, k, n, seed=n), torch.float32)
    # fp8's accumulation keeps ~14 bits within a 128-deep tile
    torch.testing.assert_close(out[:, :n], want, rtol=1e-3, atol=2e-3 * float(want.abs().max()))


@pytest.mark.parametrize("width", [128, 1, 1000])
@pytest.mark.parametrize("name", ["move", "add.f32", "mul.f32", "fma.f32", "max.f32",
                                  "rsqrt.f32", "exp.f32", "tanh.f32", "log.f32", "add.s32",
                                  "mul.s32", "shift.s32"])
def test_op_latency_kernel(dev, name, width):
    """Each chain against the same chain as PyTorch ops on the card: equal
    for the arithmetic ops (fma as one rounding); the transcendental ones
    within 1e-6, the library routines' ulps."""
    from repro_torch.kernels import op_latency as ops

    x0 = ops.chain_input(ops.OPS[name][0], width, dev)
    got = ops.op_chain(name, x0, 4096)
    want = ops.op_chain_ref(name, x0, 4096)
    if name.split(".")[0] in ("rsqrt", "exp", "tanh", "log"):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(got, want)


def test_op_latency_probe_times_the_alu(dev):
    _util.reset_launch_counts()
    res = probes.probe_op_latency(chain=4096, device=dev)
    lat = dict(zip(res.x, res.y))
    assert res.meta["backend"] == "cuda" and _util.launch_counts()["op_latency"] > 0
    assert all(np.isfinite(v) and v >= 0 for v in lat.values())
    assert all(lat[op] < 10 for op in ("add.f32", "mul.f32", "fma.f32"))


@pytest.mark.parametrize("dtype,tol", _SSM_TOL)
@pytest.mark.parametrize("bsz,s,h,p,n,chunk", [(1, 1024, 2, 64, 64, 512), (1, 512, 3, 192, 16, 256),
                                               (1, 512, 2, 16, 192, 256),
                                               (1, 1024, 1, 160, 300, 1024),
                                               (1, 12288, 1, 128, 128, 12288)])
def test_ssm_scan_kernel_past_the_old_limits(dev, dtype, tol, bsz, s, h, p, n, chunk):
    """Chunks past 256 (the cumulative decay scanned in segments with a
    carry; at 12288 with P = N = 128 it no longer fits beside the tiles in
    shared memory and goes to the global scratch), P past 128 (split over
    the grid) and N past 128 (slabs summed in fp32), against the chunked
    plain version at the slow decay.  bf16 at (1, 1024, 2, 64, 64), zamba2-7b's
    P and N at the autotuner's chunk 512, and at P = N = 128 takes the wgmma
    route; fp16 takes the SIMT one everywhere."""
    from repro_torch.kernels.ssm_scan import DIM_TILE

    if chunk == 12288:
        assert not _util.library().repro_ssm_scan_acum_fits(min(p, DIM_TILE), min(n, DIM_TILE),
                                                            chunk)
    u, a, b, c = _ssm_inputs(dev, dtype, bsz, s, h, p, n, seed=p + n, decay="slow")
    got = tapi.ssm_scan(u, a, b, c, chunk=chunk)
    want = ref.ssm_scan_chunked_ref(*_util.flatten_ssm(u, a, b, c), chunk)
    want = _util.unflatten_heads(want, bsz).float()
    scale = float(want.abs().max())
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd,h,hkv,causal", [(320, 4, 2, True), (512, 2, 2, False),
                                             (264, 3, 1, True)])
def test_flash_attention_wide_head(dev, dtype, tol, hd, h, hkv, causal):
    """Head widths past 256 through the op, on the wide SIMT kernel."""
    q = _rand((2, 200, h, hd), dev, dtype, 1)
    k, v = (_rand((2, 200, hkv, hd), dev, dtype, s) for s in (2, 3))
    before = _util.launch_counts().get("flash_attention", 0)
    got = tapi.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _util.launch_counts()["flash_attention"] == before + 1
    want = tapi.flash_attention(q.float(), k.float(), v.float(), causal=causal, backend="torch")
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# ssm_scan's wgmma route pass by pass, and the routes it leaves to the SIMT kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,tol", _SSM_TOL[1:])
@pytest.mark.parametrize("bsz,s,h,p,n,chunk", [(2, 512, 3, 64, 64, 128), (1, 240, 2, 16, 32, 40),
                                               (1, 256, 1, 128, 128, 256),
                                               (1, 192, 2, 80, 48, 64), (1, 1024, 2, 64, 64, 512)])
def test_ssd_passes_against_their_plain_versions(dev, dtype, tol, bsz, s, h, p, n, chunk):
    """Each pass on the plain version's own inputs at the slow decay: pass 1's
    acum within fp32 sum order (1e-5 of max |acum|) and its chunk states
    within 1e-4 of their max (sdecay B enters as a hi + lo pair of 16-bit
    values, ~16 bits); pass 2 within 1e-5 (the same fp32 recurrence); pass 3
    within one rounding of y to the 16-bit type."""
    from repro_torch.kernels import ssm_scan as ssd

    u, a, b, c = _ssm_inputs(dev, dtype, bsz, s, h, p, n, seed=p + n + chunk, decay="slow")
    _util.reset_launch_counts()
    states, acum = ssd.ssd_chunk_states_cuda(u, a, b, chunk=chunk)
    want_states, want_acum = ref.ssd_chunk_states(u, a, b, chunk)
    torch.testing.assert_close(acum, want_acum, rtol=1e-5,
                               atol=1e-5 * float(want_acum.abs().max()))
    torch.testing.assert_close(states, want_states, rtol=1e-4,
                               atol=1e-4 * float(want_states.abs().max()))
    entering = ssd.ssd_pass_states_cuda(want_states.clone(), want_acum, chunk=chunk)
    want_entering, _ = ref.ssd_pass_states(want_states, want_acum, chunk)
    torch.testing.assert_close(entering, want_entering, rtol=1e-5,
                               atol=1e-5 * float(want_entering.abs().max()))
    got = ssd.ssd_chunk_outputs_cuda(u, b, c, want_entering, want_acum, chunk=chunk)
    want = ref.ssd_chunk_outputs(u, b, c, want_entering, want_acum, chunk)
    assert got.shape == u.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol * float(want.abs().max()))
    torch.cuda.synchronize()
    assert _util.launch_counts() == {"ssd_chunk_states": 1, "ssd_pass_states": 1,
                                     "ssd_chunk_outputs": 1}


@pytest.mark.parametrize("dtype,p,n,route", [
    (torch.float32, 64, 64, "simt"), (torch.bfloat16, 192, 16, "simt"),
    (torch.bfloat16, 16, 300, "simt"), (torch.float16, 64, 24, "simt"),
    (torch.bfloat16, 64, 64, "wgmma"), (torch.float16, 48, 128, "simt"),
])
def test_ssm_scan_routes(dev, dtype, p, n, route):
    """fp32, fp16, P past 128, N past 128 and N off the multiples of 16 stay
    on the SIMT kernel; each call counts one ssm_scan launch and one of its
    route."""
    u, a, b, c = _ssm_inputs(dev, dtype, 1, 256, 2, p, n, seed=p + n, decay="slow")
    _util.reset_launch_counts()
    got = tapi.ssm_scan(u, a, b, c, chunk=128)
    torch.cuda.synchronize()
    assert _util.launch_counts() == {"ssm_scan": 1}
    assert _util.route_counts() == {"ssm_scan": {route: 1}}
    want = ref.ssm_scan_chunked_ref(*_util.flatten_ssm(u, a, b, c), 128)
    want = _util.unflatten_heads(want, 1).float()
    tol = dict(_SSM_TOL)[dtype]
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol * float(want.abs().max()))


def fp16_state_case(device, bsz=1, s=1024, h=2, p=64, n=64):
    """fp16 inputs whose SSD state passes fp16's 65,504 while y stays inside
    it: u ~ 100, B ~ 30 and C ~ 1e-3 (each within 10 %, from numpy's seed 0,
    so the same on any device) at a slow, constant decay of 0.01 a step.  The
    state settles near 3e5, y near 2e4."""
    rng = np.random.default_rng(0)

    def around(v, shape):
        x = v * (1 + 0.1 * rng.standard_normal(shape, dtype=np.float32))
        return torch.from_numpy(x).to(device)

    u = around(100.0, (bsz, s, h, p)).half()
    b, c = around(30.0, (bsz, s, n)).half(), around(1e-3, (bsz, s, n)).half()
    return u, torch.full((bsz, s, h), -0.01, device=device), b, c


def test_ssm_scan_fp16_state_past_the_fp16_range(dev):
    """The reference keeps the state in fp32 whatever the input type
    (``repro/kernels/ssm_scan.py``, ``h_ref``); so must the kernel, when the
    state passes 65,504 and y does not.  Within the fp16 limit of
    ``_SSM_TOL`` of the fp32 plain version on the same fp16 inputs."""
    chunk = 256
    u, a, b, c = fp16_state_case(dev)
    states, acum = ref.ssd_chunk_states(u.float(), a, b.float(), chunk)
    entering, _ = ref.ssd_pass_states(states, acum, chunk)
    want = ref.ssm_scan_chunked_ref(*_util.flatten_ssm(u.float(), a, b.float(), c.float()),
                                    chunk)
    want = _util.unflatten_heads(want, 1)
    assert float(entering.abs().max()) > 65504 > float(want.abs().max())
    got = tapi.ssm_scan(u, a, b, c, chunk=chunk)
    assert bool(torch.isfinite(got).all())
    tol = dict(_SSM_TOL)[torch.float16]
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol * float(want.abs().max()))


def test_ssm_scan_wgmma_copies_a_misaligned_view(dev):
    """A view of u, b and c at an offset off the TMA's 16 bytes still runs
    (the wrapper copies it), and matches the same values aligned."""
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    u, a, b, c = _ssm_inputs(dev, torch.bfloat16, 1, 128, 2, 64, 32, seed=3, decay="slow")
    shifted = [torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape) for t in (u, b, c)]
    assert all(t.data_ptr() % 16 for t in shifted)
    want = ssm_scan_cuda(u, a, b, c, chunk=64)
    torch.testing.assert_close(ssm_scan_cuda(shifted[0], a, *shifted[1:], chunk=64), want,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the paper's suites through their cuda variants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kernel", [
    ("bandwidth[cuda]", "stream_reduce"), ("axpy[cuda]", "axpy"), ("memhier[cuda]", "pchase"),
    ("scheduler[cuda]", "stream_reduce"), ("instr", "op_latency"),
])
def test_paper_suite_runs_its_kernel(dev, name, kernel):
    """Each suite's cuda path, quick: every point measured (no skipped row),
    finite and positive, on the card's kernel (its launch count rises)."""
    from repro_torch.bench import runner
    from repro_torch.core import registry

    runner.load_suites()
    before = _util.launch_counts().get(kernel, 0)
    recs = registry.get(name).run("quick", {"device": str(dev)})
    torch.cuda.synchronize()
    assert _util.launch_counts().get(kernel, 0) > before
    assert recs and not any("skipped" in r.name for r in recs)
    assert all(np.isfinite(r.value) and r.value > 0 for r in recs if r.measured)
