"""The port's attention paths against the reference's on the CPU.

The same numpy q/k/v go through the reference's ``pallas_attention`` (its
Pallas flash kernel in interpret mode, as the reference's tests run it) and
the port's: with GQA group sizes 1, 2, 4 and 8 (the port hands the op the
unexpanded KV heads; its plain version expands them as ``jnp.repeat``
does), causal and not, a sequence that is not a multiple of the block, and
a query offset.  The host-side logic of the tensor-core kernel (which head
widths need the padding copy, the tensor maps' dims and strides) is plain
Python and is held here too.  The kernel op's own wrapper (padding Sq to
``bq`` and Skv to ``bk``, masking keys past the true Skv, slicing back) runs
on CPU tensors with its plain version.  Tolerance: float32, rtol = atol =
1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro_torch.kernels import api as tapi
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention_cuda, flash_attention_model,
                                                 kernel_head_dim, tma_dims_strides,
                                                 tma_head_dim)
from repro_torch.models import attention as tattn

TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(b, sq, skv, h, kh, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kh, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("causal,sq,q_offset", [(True, 40, 0), (False, 40, 0), (True, 24, 16)])
def test_pallas_attention_parity(g, causal, sq, q_offset):
    q, k, v = _qkv(2, sq, 40, 4, 4 // g, 16, seed=g)
    want = jattn.pallas_attention(*map(jnp.asarray, (q, k, v)), causal=causal, chunk=16,
                                  q_offset=q_offset)
    got = tattn.pallas_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, chunk=16,
                                 q_offset=q_offset)
    assert got.shape == (2, sq, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the port's plain blockwise and naive paths compute the same function
    blk = tattn.blockwise_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, chunk=16,
                                    q_offset=q_offset)
    naive = tattn.naive_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                  q_offset=q_offset)
    for other in (blk, naive):
        np.testing.assert_allclose(other.numpy(), np.asarray(want), **TOL)


def test_kv_heads_expand_in_repeat_order():
    q, k, v = _qkv(1, 8, 8, 4, 2, 16, seed=9)
    k[:, :, 1] += 5.0  # tell the two KV heads apart
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tattn.pallas_attention(tq, tk, tv, causal=True, chunk=8)
    # query heads 0, 1 read KV head 0 and heads 2, 3 read KV head 1
    for h in range(4):
        one = tattn.pallas_attention(tq[:, :, h:h + 1], tk[:, :, h // 2:h // 2 + 1],
                                     tv[:, :, h // 2:h // 2 + 1], causal=True, chunk=8)
        np.testing.assert_allclose(got[:, :, h].numpy(), one[:, :, 0].numpy(), **TOL)


@pytest.mark.parametrize("causal,sq,skv,q_offset,tiles", [
    (True, 40, 40, 0, {"bq": 16, "bk": 16}),   # both padded: 48 / 48
    (True, 50, 50, 0, {"bq": 128, "bk": 24}),  # bq clamps to 50, Skv padded to 72
    (False, 24, 40, 0, {"bq": 16, "bk": 32}),
    (True, 24, 40, 16, {"bq": 8, "bk": 16}),
])
def test_kernel_wrapper_pads_like_the_reference(causal, sq, skv, q_offset, tiles):
    q, k, v = _qkv(2, sq, skv, 2, 2, 16, seed=sq + skv)
    want = japi.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, q_offset=q_offset,
                                backend="interpret", **tiles)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tapi.flash_attention.impl("cuda")(tq, tk, tv, causal=causal, q_offset=q_offset, **tiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tapi.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset, **tiles)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_len", [40, 33, 17])
def test_padded_keys_are_masked(kv_len):
    q, k, v = (np.random.default_rng(s).normal(size=(3, 32, 16)).astype(np.float32)
               for s in (1, 2, 3))
    k40, v40 = (np.pad(a, ((0, 0), (0, 8), (0, 0))) for a in (k, v))
    k40[:, kv_len:] = 7.0  # garbage past kv_len must not leak in
    want = flash_attention_pallas(*map(jnp.asarray, (q, k40, v40)), causal=False, bq=16, bk=8,
                                  kv_len=kv_len)
    got = flash_attention_cuda(*map(torch.from_numpy, (q, k40, v40)), causal=False, bq=16, bk=8,
                               kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    short = tref.flash_attention_ref(*map(torch.from_numpy, (q, k40[:, :kv_len], v40[:, :kv_len])),
                                     causal=False)
    np.testing.assert_allclose(got.numpy(), short.numpy(), **TOL)


def test_kernel_wrapper_checks_its_inputs():
    q = torch.zeros((2, 32, 16))
    with pytest.raises(ValueError, match="divide"):
        flash_attention_cuda(q, q, q, bq=24, bk=16)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_cuda(q, q, q, bq=16, bk=16, kv_len=33)
    with pytest.raises(TypeError, match="share a dtype"):
        flash_attention_cuda(q, q.double(), q, bq=16, bk=16)
    with pytest.raises(ValueError, match="match"):
        flash_attention_cuda(q, torch.zeros((3, 32, 16)), torch.zeros((3, 32, 16)), bq=16, bk=16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tapi.flash_attention(q[None], q[None], q[None], backend="cuda")


@pytest.mark.parametrize("hd,width", [(16, 64), (112, 128), (200, 256)])
def test_head_width_padding_is_exact(hd, width):
    """The kernel wrapper zero-pads hd up to its template width and scales by
    the true hd ** -0.5: the plain version on the padded operands equals the
    plain version on the unpadded ones, and zamba2-7b's hd 112 runs at 128."""
    assert kernel_head_dim(hd) == width
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 24, 24, 3, 3, hd, seed=hd)[:3])
    q, k, v = (t.permute(0, 2, 1, 3).reshape(3, 24, hd) for t in (q, k, v))
    want = tref.flash_attention_ref(q, k, v, causal=True)
    padded = [torch.nn.functional.pad(t, (0, width - hd)) for t in (q, k, v)]
    got = tref.flash_attention_ref(*padded, causal=True, scale=hd ** -0.5)
    np.testing.assert_allclose(got[..., :hd].numpy(), want.numpy(), **TOL)
    assert float(got[..., hd:].abs().max()) == 0.0
    np.testing.assert_allclose(flash_attention_cuda(q, k, v, bq=8, bk=8).numpy(), want.numpy(),
                               **TOL)
    with pytest.raises(ValueError, match="up to 256"):
        kernel_head_dim(264)


@pytest.mark.parametrize("b,s,rows,hd,width", [(2, 40, 48, 16, 64), (1, 24, 24, 112, 128)])
def test_operands_are_padded_in_one_copy(b, s, rows, hd, width):
    """The cuda wrapper's operand: the head-flattened rows, zero past S and hd,
    contiguous, and a copy rather than a view of the model's tensor."""
    from repro_torch.kernels import _util

    x = torch.from_numpy(np.random.default_rng(hd).normal(size=(b, s, 3, hd)).astype(np.float32))
    got = _util.flatten_heads_padded(x, rows, width)
    want = torch.nn.functional.pad(_util.flatten_heads(x), (0, width - hd, 0, rows - s))
    assert got.is_contiguous() and got.data_ptr() != x.data_ptr()
    assert torch.equal(got, want)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [16, 48])
@pytest.mark.parametrize("causal,sq,skv,q_offset", [(True, 40, 40, 0), (False, 24, 40, 0),
                                                    (True, 24, 40, 16)])
def test_grouped_kv_heads_parity(g, hd, causal, sq, skv, q_offset):
    """``api.flash_attention`` takes k/v with H / g heads: on the CPU every
    entry of the port (the op, its cuda wrapper, and the model-layout kernel
    wrapper) matches the reference's ``pallas_attention``, which expands the
    KV heads with ``jnp.repeat`` and runs its Pallas kernel in interpret mode."""
    q, k, v = _qkv(2, sq, skv, 8, 8 // g, hd, seed=10 * g + hd)
    want = np.asarray(jattn.pallas_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                             chunk=16, q_offset=q_offset))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (tapi.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset, bk=16),
                tapi.flash_attention.impl("cuda")(tq, tk, tv, causal=causal, q_offset=q_offset,
                                                  bk=16),
                flash_attention_model(tq, tk, tv, causal=causal, q_offset=q_offset)):
        assert got.shape == (2, sq, 8, hd)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n_heads,n_kv", [(4, 4), (4, 2), (8, 1)])
def test_pallas_attention_hands_the_op_unexpanded_kv(monkeypatch, n_heads, n_kv):
    """The model's kernel path passes the KV heads as they are; the op (and
    on the card, the kernel) reads query head h from KV head h // g."""
    seen = []
    real = tapi.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tapi, "flash_attention", spy)
    q, k, v = map(torch.from_numpy, _qkv(1, 12, 12, n_heads, n_kv, 16, seed=n_heads * n_kv))
    tattn.pallas_attention(q, k, v, causal=True, chunk=8)
    assert seen == [((1, 12, n_heads, 16), (1, 12, n_kv, 16), (1, 12, n_kv, 16))]


@pytest.mark.parametrize("dtype,hd,width", [
    (torch.bfloat16, 256, 256), (torch.bfloat16, 112, 112), (torch.float16, 16, 16),
    (torch.bfloat16, 8, 8), (torch.bfloat16, 12, 16), (torch.float16, 100, 104),
    (torch.float32, 64, 64), (torch.float32, 110, 112),
])
def test_when_a_head_width_needs_the_padding_copy(dtype, hd, width):
    """Operands are read in place when a row of hd is a multiple of the TMA's
    16-byte stride unit; any other width is zero-padded, in the model layout,
    to the next such width."""
    assert tma_head_dim(hd, torch.tensor([], dtype=dtype).element_size()) == width
    with pytest.raises(ValueError, match="up to 256"):
        tma_head_dim(264, 2)


def test_tensor_map_shapes_and_strides():
    """The 4-D maps the kernel reads: dims innermost first (hd, H, S, B) and
    the byte strides of H, S and B, from the tensor's own strides."""
    q = torch.zeros((4, 1000, 8, 256), dtype=torch.bfloat16)
    assert tma_dims_strides(q.shape, q.stride(), 2) == ((256, 8, 1000, 4), (512, 4096, 4096000))
    k = torch.zeros((4, 1000, 1, 256), dtype=torch.bfloat16)
    assert tma_dims_strides(k.shape, k.stride(), 2) == ((256, 1, 1000, 4), (512, 512, 512000))
    z = torch.zeros((4, 1000, 32, 112), dtype=torch.bfloat16)  # zamba2-7b: no padding to 128
    assert tma_dims_strides(z.shape, z.stride(), 2) == ((112, 32, 1000, 4), (224, 7168, 7168000))
    flat = torch.zeros((128, 1024, 112), dtype=torch.float16)[:, :, None]  # (BH, S, hd) as H = 1
    assert tma_dims_strides(flat.shape, flat.stride(), 2) == ((112, 1, 1024, 128),
                                                              (224, 224, 229376))
    # a slice of heads out of a fused qkv projection keeps its strides, no copy
    qkv = torch.zeros((2, 10, 3, 4, 64), dtype=torch.bfloat16)
    kk = qkv[:, :, 1]
    assert tma_dims_strides(kk.shape, kk.stride(), 2) == ((64, 4, 10, 2), (128, 1536, 15360))
    with pytest.raises(ValueError, match="multiples of 16"):
        odd = torch.zeros((2, 10, 3, 12), dtype=torch.bfloat16)
        tma_dims_strides(odd.shape, odd.stride(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        tr = torch.zeros((2, 64, 3, 10), dtype=torch.bfloat16).transpose(1, 3)
        tma_dims_strides(tr.shape, tr.stride(), 2)


def test_model_layout_wrapper_checks_its_inputs():
    q = torch.zeros((1, 8, 6, 16))
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_model(q, torch.zeros((1, 8, 4, 16)), torch.zeros((1, 8, 4, 16)))
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_model(q, q, q, kv_len=9)
    with pytest.raises(ValueError, match="do not group"):
        tapi.flash_attention(q, q[:, :, :4], q[:, :, :4])


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 6), (torch.float32, 10),
                                      (torch.bfloat16, 12), (torch.float16, 20)])
def test_model_layout_pads_a_head_width_off_the_tma_unit(dtype, hd):
    """A row of hd that is not a whole number of 16 bytes is zero-padded in
    the model layout (grouped KV heads still unexpanded), with the true
    ``hd ** -0.5`` as the scale, and sliced back: the reference's function.
    16-bit inputs are held at 2e-2 (one rounding of the output)."""
    q, k, v = _qkv(2, 24, 24, 4, 2, hd, seed=hd)
    q, k, v = (torch.from_numpy(t).to(dtype).float().numpy() for t in (q, k, v))
    want = np.asarray(jattn.pallas_attention(*map(jnp.asarray, (q, k, v)), causal=True, chunk=8))
    tq, tk, tv = (torch.from_numpy(t).to(dtype) for t in (q, k, v))
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for got in (flash_attention_model(tq, tk, tv, causal=True),
                tapi.flash_attention(tq, tk, tv, causal=True)):
        assert got.shape == (2, 24, 4, hd) and got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_wgmma_header_matches_its_generator():
    """``csrc/wgmma.cuh`` is what ``kernels/gen_wgmma.py`` writes."""
    from repro_torch.kernels import gen_wgmma

    assert gen_wgmma.OUT.read_text() == gen_wgmma.render()
