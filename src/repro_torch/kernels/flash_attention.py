"""Flash attention: blockwise online softmax with the running (m, l, acc)
state kept on chip.

The kernels (``csrc/flash_attention.cu``) replace the Pallas ``_flash_kernel``
of ``repro/kernels/flash_attention.py``.  Causal attention at the LMs'
shapes sits at the tensor cores' ridge, so the card's floor is theirs.

* bf16 and fp16 (:func:`flash_attention_model`, every 16-bit call): tensor
  cores (``wgmma``) fed by the TMA.  The kernel reads the model layout, q
  (B, Sq, H, hd) and k/v (B, Skv, Hkv, hd), through 4-D tensor maps: grouped
  KV heads are read in place (query head ``h`` reads KV head ``h // (H //
  Hkv)``, ``jnp.repeat``'s order), rows past S and columns past hd arrive as
  zeros, so nothing is expanded or padded in memory, and hd 112 runs at its
  own width.  Only a head width whose row pitch is not a multiple of 16
  bytes (the TMA's stride unit) is zero-padded, in the same layout
  (:func:`tma_head_dim`).
* fp32: the FP32 pipes, since TF32 would not keep fp32's 1e-4.  That kernel
  takes the head-flattened layout at hd 64, 128 or 256; any other width up to
  256 is zero-padded to the next of them and scaled by the true
  ``hd ** -0.5``, which gives the same function.
* every type at hd > 256 (:func:`flash_attention_wide`): a SIMT kernel on the
  head-flattened layout at the head's own width, each block computing a
  slice of 256 output columns over scores taken across the whole width.

The reference's ``saturation_check`` guard sentinel waits for the port of
``kernels/guard.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _util, ref

HEAD_DIMS = (64, 128, 256)  # the fp32 kernel's template instances
MAX_HEAD_DIM = 256
TMA_DTYPES = (torch.bfloat16, torch.float16)
TMA_STRIDE_BYTES = 16  # the TMA's unit of a global stride


def kernel_head_dim(hd: int) -> int:
    """The fp32 kernel's template width a head width of ``hd`` runs at; past
    ``MAX_HEAD_DIM``, ``hd`` itself (the wide kernel's own width)."""
    for width in HEAD_DIMS:
        if hd <= width:
            return width
    return hd


def tma_head_dim(hd: int, element_size: int) -> int:
    """``hd`` rounded up to a whole number of the TMA's 16-byte stride units:
    the head width the tensor-core kernel reads (up to ``MAX_HEAD_DIM``; a
    wider head goes to the wide kernel).  The extra columns are zeros, which
    add nothing to q.k and are sliced off the output."""
    unit = TMA_STRIDE_BYTES // element_size
    return -(-hd // unit) * unit


def tma_dims_strides(shape, strides, element_size: int) -> tuple:
    """The 4-D tensor map of a (B, S, H, hd) operand with element ``strides``:
    dims innermost first (hd, H, S, B) and the byte strides of the H, S and B
    axes.  Raises unless hd is contiguous and the strides are multiples of
    16 bytes."""
    b, s, h, hd = shape
    if strides[3] != 1:
        raise ValueError(f"the head axis must be contiguous, got strides {tuple(strides)}")
    byte_strides = (strides[2] * element_size, strides[1] * element_size,
                    strides[0] * element_size)
    if any(st % TMA_STRIDE_BYTES for st in byte_strides):
        raise ValueError(f"byte strides {byte_strides} are not multiples of {TMA_STRIDE_BYTES}")
    return (hd, h, s, b), byte_strides


def expand_kv_heads(k: torch.Tensor, v: torch.Tensor, n_heads: int) -> tuple:
    """(B, S, Hkv, hd) -> (B, S, n_heads, hd), each KV head repeated in place
    (``jnp.repeat``'s order).  What the kernel reads without copying; the plain
    version and the fp32 kernel take the expanded heads."""
    hkv = k.shape[2]
    if n_heads % hkv:
        raise ValueError(f"{n_heads} query heads do not group over {hkv} KV heads")
    g = n_heads // hkv
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def _in_place_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the TMA can read it, else a contiguous copy."""
    es = t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % TMA_STRIDE_BYTES == 0
            and all((st * es) % TMA_STRIDE_BYTES == 0 for st in t.stride()[:3])):
        return t
    return t.contiguous()


_ARGTYPES = (
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float,
)
_WIDE_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float,
)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_TMA_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    _U64P, _U64P, _U64P, _U64P, _U64P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
)


def _u64(values) -> ctypes.Array:
    return (ctypes.c_uint64 * len(values))(*values)


def flash_attention_wide(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    q_offset: int = 0, kv_len: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """q (BH, Sq, hd), k/v (BH, Skv, hd), the head-flattened layout at any
    head width, float32/bfloat16/float16: the wide kernel, which the other
    wrappers send every hd > ``MAX_HEAD_DIM``.  ``kv_len`` (default Skv)
    masks keys from that index on; ``scale`` defaults to ``hd ** -0.5``.  On
    CUDA tensors this launches the kernel; CPU tensors take the plain
    version."""
    bh, sq, hd = q.shape
    skv = k.shape[1]
    kv_len = skv if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                                       scale=scale)
    if q.dtype not in _util.FLOAT_DTYPES:
        raise TypeError(f"flash_attention kernel takes float32/bfloat16/float16, got {q.dtype}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    _util.launch("flash_attention", "repro_flash_attention_wide", _WIDE_ARGTYPES, q.device,
                 _util.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), bh, sq, skv, hd, kv_len, q_offset, int(causal), scale)
    return out


def flash_attention_model(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    q_offset: int = 0, kv_len: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, Hkv, hd) with H % Hkv == 0: the model
    layout, bf16 or fp16, read in place by the tensor-core kernel (hd is
    zero-padded to :func:`tma_head_dim` first where a row is not a whole
    number of 16 bytes).  A head wider than ``MAX_HEAD_DIM`` goes to
    :func:`flash_attention_wide` with the KV heads expanded.

    ``kv_len`` (default Skv) masks keys from that index on; ``scale``
    (default ``hd ** -0.5``) multiplies the scores.  The output is (B, Sq,
    H, hd) in q's dtype.  On CUDA tensors this launches the kernel; CPU
    tensors take the plain version, on the same padded operands after
    expanding the KV heads.
    """
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,Sq,H,hd) and k/v (B,Skv,Hkv,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    kv_len = skv if kv_len is None else kv_len
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} outside [0, {skv}]")
    scale = hd ** -0.5 if scale is None else scale
    if hd > MAX_HEAD_DIM:
        ke, ve = expand_kv_heads(k, v, h)
        out = flash_attention_wide(*(_util.flatten_heads(t) for t in (q, ke, ve)), causal=causal,
                                   q_offset=q_offset, kv_len=kv_len, scale=scale)
        return _util.unflatten_heads(out, b)
    width = tma_head_dim(hd, q.element_size())
    if width != hd:
        q, k, v = (F.pad(t, (0, width - hd)) for t in (q, k, v))
    if q.device.type == "cpu":
        ke, ve = expand_kv_heads(k, v, h)
        out = ref.flash_attention_ref(*(_util.flatten_heads(t) for t in (q, ke, ve)),
                                      causal=causal, q_offset=q_offset, kv_len=kv_len,
                                      scale=scale)
        return _util.unflatten_heads(out, b)[..., :hd]
    if q.dtype not in TMA_DTYPES:
        raise TypeError(f"the tensor-core kernel takes bfloat16/float16, got {q.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must share a device, got {q.device}, {k.device}, {v.device}")
    q, k, v = (_in_place_operand(t) for t in (q, k, v))
    q_dims, q_strides = tma_dims_strides(q.shape, q.stride(), q.element_size())
    kv_dims, k_strides = tma_dims_strides(k.shape, k.stride(), k.element_size())
    _, v_strides = tma_dims_strides(v.shape, v.stride(), v.element_size())
    out = torch.empty((b, sq, h, width), dtype=q.dtype, device=q.device)
    _util.launch("flash_attention", "repro_flash_attention_tma", _TMA_ARGTYPES, q.device,
                 _util.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), _u64(q_dims), _u64(q_strides), _u64(kv_dims), _u64(k_strides),
                 _u64(v_strides), h * width, width, sq * h * width, kv_len, q_offset, int(causal),
                 scale)
    return out[..., :hd]


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    q_offset: int = 0, bq: int = 128, bk: int = 128, kv_len: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (BH, Sq, hd), k/v (BH, Skv, hd), the head-flattened layout, the
    counterpart of ``flash_attention_pallas``.

    Sq and Skv must divide into ``bq`` and ``bk`` (the wrapper in
    ``kernels.api`` pads them); ``kv_len``, the true key count, masks the
    padded keys.  bf16/fp16 go to :func:`flash_attention_model` as the model
    layout with B = BH and H = 1.  fp32 zero-pads a head width outside
    ``HEAD_DIMS`` to the next one, with the true ``hd ** -0.5`` as the scale
    (and a head wider than the last goes to :func:`flash_attention_wide`);
    a caller that has padded hd itself passes the true ``scale``.  The output
    has q's shape and dtype.  On CUDA tensors this launches a kernel; CPU
    tensors take the plain version, on the same padded operands.
    """
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3:
        raise ValueError(f"need q (BH,Sq,hd) and k/v (BH,Skv,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, hd = q.shape
    skv = k.shape[1]
    if k.shape[0] != bh or k.shape[2] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if sq % bq or skv % bk:
        raise ValueError(f"Sq {sq} / Skv {skv} do not divide into bq {bq} / bk {bk}")
    kv_len = skv if kv_len is None else kv_len
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} outside [0, {skv}]")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    scale = hd ** -0.5 if scale is None else scale
    if q.dtype in TMA_DTYPES:
        out = flash_attention_model(q[:, :, None], k[:, :, None], v[:, :, None], causal=causal,
                                    q_offset=q_offset, kv_len=kv_len, scale=scale)
        return out[:, :, 0]
    width = kernel_head_dim(hd)
    if width > MAX_HEAD_DIM:
        return flash_attention_wide(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                                    scale=scale)
    if width != hd:
        q, k, v = (F.pad(t, (0, width - hd)) for t in (q, k, v))
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                                      scale=scale)
        return out[..., :hd]
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention kernel takes float32/bfloat16/float16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _util.check_cuda_operand(name, t)
    out = torch.empty_like(q)
    _util.launch("flash_attention", "repro_flash_attention", _ARGTYPES, q.device,
                 _util.DTYPE_CODES[q.dtype], width, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), bh, sq, skv, kv_len, q_offset, int(causal), scale)
    return out[..., :hd]
