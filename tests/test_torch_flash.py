"""The port's attention paths against the reference's on the CPU.

The same numpy q/k/v go through the reference's ``pallas_attention`` (its
Pallas flash kernel in interpret mode, as the reference's tests run it) and
the port's: with GQA group sizes 1, 2 and 4 (the port expands KV heads as
``jnp.repeat`` does), causal and not, a sequence that is not a multiple of
the block, and a query offset.  The kernel op's own wrapper (padding Sq to
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
from repro_torch.kernels.flash_attention import flash_attention_cuda, kernel_head_dim
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
