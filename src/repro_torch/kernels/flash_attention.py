"""Flash attention: blockwise online softmax with the running (m, l, acc)
state kept on chip.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas ``_flash_kernel``
of ``repro/kernels/flash_attention.py``.  One block of 256 threads owns 64
query rows of one (batch*head) and loops over 64-key tiles staged in shared
memory in the input dtype; scores, softmax state and the accumulator are
fp32, on the FP32 pipes.  Tiles past the causal diagonal are never loaded.
It is bound by operations at the model's shapes; the tensor cores
(wgmma/TMA) and native GQA are later work (ROADMAP.md).

The kernel is instantiated at head widths 64, 128 and 256.  Any other width
up to 256 is zero-padded to the next of them and the scores are scaled by
the true ``hd ** -0.5``: zero columns add exactly 0 to q.k and give zero
output columns, which are sliced off, so the result is the same function.
At zamba2-7b's hd 112 that moves 128/112 of the bytes.

The reference's ``saturation_check`` guard sentinel waits for the port of
``kernels/guard.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _util, ref

HEAD_DIMS = (64, 128, 256)  # the kernel's template instances


def kernel_head_dim(hd: int) -> int:
    """The template width a head width of ``hd`` runs at (zero-padded up)."""
    for width in HEAD_DIMS:
        if hd <= width:
            return width
    raise ValueError(f"flash_attention takes head_dim up to {HEAD_DIMS[-1]}, got {hd}")
_ARGTYPES = (
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float,
)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    q_offset: int = 0, bq: int = 128, bk: int = 128, kv_len: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (BH, Sq, hd), k/v (BH, Skv, hd), the head-flattened layout.

    Sq and Skv must divide into ``bq`` and ``bk`` (the wrapper in
    ``kernels.api`` pads them); ``kv_len``, the true key count, masks the
    padded keys.  A head width outside ``HEAD_DIMS`` is zero-padded to the
    next one, with the true ``hd ** -0.5`` as the scale; a caller that has
    padded hd itself passes the true ``scale``.  The output has q's shape
    and dtype.  On CUDA tensors this launches the kernel; CPU tensors
    take the plain version, on the same padded operands.
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
    width = kernel_head_dim(hd)
    scale = hd ** -0.5 if scale is None else scale
    if width != hd:
        q, k, v = (F.pad(t, (0, width - hd)) for t in (q, k, v))
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                                      scale=scale)
        return out[..., :hd]
    if q.dtype not in _util.DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32/bfloat16/float16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _util.check_cuda_operand(name, t)
    out = torch.empty_like(q)
    _util.launch("flash_attention", "repro_flash_attention", _ARGTYPES, q.device,
                 _util.DTYPE_CODES[q.dtype], width, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), bh, sq, skv, kv_len, q_offset, int(causal), scale)
    return out[..., :hd]
