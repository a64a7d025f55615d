"""Tiled matmul kernels — the §4.4 arithmetic-throughput probe and the
Tab 4.3 precision ladder (``csrc/matmul.cu``).

Both replace the Pallas ``_matmul_kernel`` of ``repro/kernels/matmul.py``,
which accumulates in fp32 and casts to ``out_dtype``; every output type of
the reference runs (float32, bfloat16, float16, int32, int8, fp8 e4m3), cast
as the reference casts (:func:`repro_torch.kernels.ref.cast_like_xla`).

* float32: the FP32 pipes (67 TFLOP/s), and it stays there: the ``dissect``
  fit reads its rate as the card's fp32 peak, so no TF32 and no tensor-core
  emulation.  Each block of 256 threads owns a 128x256 output tile with an
  8x16 fp32 accumulator per thread and streams K through a 4-stage ring in
  shared memory (B by ``cp.async``, A by 16-byte loads written transposed).
  Any M, N, K runs (zero-filled edges; rows that are not 16-byte aligned
  take a one-element-load instance of the same kernel).
* bfloat16, float16, int8 and float8_e4m3fn: the tensor cores, by ``wgmma``
  fed by the TMA, 128x128 output tiles, fp32 accumulators (s32 for int8,
  which is exact where the reference's fp32 is exact only below 2^24; fp8 is
  added into fp32 every 128 values of K).  ``wgmma`` reads 16-bit B as it
  lies, (K, N) row-major; the 8-bit types must be K-major, so their B is
  first written transposed, (N, K), by a byte-transpose kernel (its own
  launch, ``matmul_transpose``).  A row that is not a whole number of 16
  bytes (the TMA's stride unit) is zero-padded first.

:func:`saturation_check` is the numerics guard's sentinel for this op
(registered by ``kernels.api``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.autotune import dtype_name

from . import _util, ref

#: input dtypes on the tensor cores, and the name their launches count under
TC_KERNELS = {
    torch.bfloat16: "matmul_bf16",
    torch.float16: "matmul_fp16",
    torch.int8: "matmul_int8",
    torch.float8_e4m3fn: "matmul_fp8",
}
IN_DTYPES = (torch.float32, *TC_KERNELS)
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int8,
              torch.float8_e4m3fn)
TMA_STRIDE_BYTES = 16  # the TMA's unit of a global row stride
#: |out| within this factor of finfo.max counts as saturated for float dtypes
_SATURATION_MARGIN = 0.99

_ARGTYPES = (
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
)
_TC_ARGTYPES = (
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong,
)
_TRANSPOSE_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
)


def saturation_check(args, out):
    """Guard sentinel: fraction of the matmul output lost to overflow or
    saturation, plus a human-readable detail (see ``repro_torch.kernels.guard``).

    Integer outputs need the bound computed from the *inputs*: an accumulate
    that overflows the output's range wraps or saturates on the cast, so
    inspecting ``out`` alone has false negatives.  ``|a| @ |b|`` is a
    triangle-inequality upper bound — every entry it clears is provably safe,
    every entry past the dtype max is counted saturated (conservative, zero
    false negatives).  It is computed in float64, which is exact here
    (128 * 128 * K < 2^53 for any K below 5e11) and which the card's matmul
    takes where int64 has none.  Float outputs saturate visibly: count
    non-finite entries plus magnitudes within ``_SATURATION_MARGIN`` of
    ``finfo.max`` for the narrow dtypes (fp16/bf16); fp32+ counts non-finite
    only.  Everything runs on ``out``'s device; the fraction is the one
    number read back.
    """
    if out.numel() == 0:
        return 0.0, "empty output"
    if not out.dtype.is_floating_point:
        a = args[0].to(out.device, torch.float64).abs()
        b = args[1].to(out.device, torch.float64).abs()
        limit = torch.iinfo(out.dtype).max
        frac = float(((a @ b) > limit).double().mean())
        return frac, (
            f"|a|@|b| accumulation bound exceeds {dtype_name(out.dtype)} max ({limit}) on "
            f"{frac:.1%} of entries"
        )
    of = out.double()
    bad = ~torch.isfinite(of)
    detail = "non-finite entries"
    if out.dtype in (torch.float16, torch.bfloat16):
        limit = _SATURATION_MARGIN * float(torch.finfo(out.dtype).max)
        bad |= of.abs() >= limit
        detail = f"non-finite or |out| >= {_SATURATION_MARGIN:g}*finfo.max"
    return float(bad.double().mean()), detail


def tma_row(n: int, element_size: int) -> int:
    """``n`` values rounded up to a whole number of 16-byte units: the row
    length the tensor-core kernel's operands are stored at."""
    unit = TMA_STRIDE_BYTES // element_size
    return -(-n // unit) * unit


def transpose8(b: torch.Tensor) -> torch.Tensor:
    """B (K, N) of an 8-bit type -> B^T (N, K') with K' = :func:`tma_row`
    (K, 1), zero past K: the K-major operand ``wgmma`` takes for int8 and
    fp8.  On CUDA tensors this launches the transpose kernel; CPU tensors
    take the plain version."""
    k, n = b.shape
    kp = tma_row(k, 1)
    if b.device.type == "cpu":
        return ref.transpose8_ref(b, kp)
    _util.check_cuda_operand("b", b, align=1)
    bt = torch.empty((n, kp), dtype=b.dtype, device=b.device)
    _util.launch("matmul_transpose", "repro_matmul_transpose8", _TRANSPOSE_ARGTYPES, b.device,
                 b.data_ptr(), bt.data_ptr(), k, n, kp)
    return bt


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the TMA can read it (contiguous, 16-byte rows and base),
    else a copy zero-padded to 16-byte rows."""
    cols = tma_row(t.shape[1], t.element_size())
    if cols == t.shape[1] and t.is_contiguous() and t.data_ptr() % TMA_STRIDE_BYTES == 0:
        return t
    out = torch.zeros((t.shape[0], cols), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def matmul_cuda(
    a: torch.Tensor, b: torch.Tensor, *, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """a (M,K) @ b (K,N), accumulated in fp32 (s32 for int8) and cast to
    ``out_dtype`` (default a's dtype).  Any M, N, K.  On CUDA tensors this
    launches the kernel of a's dtype, and raises for a dtype with no kernel;
    CPU tensors take the plain version."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul needs (M,K) @ (K,N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    if a.dtype != b.dtype:
        raise TypeError(f"a and b must share a dtype, got {a.dtype} and {b.dtype}")
    if a.dtype not in IN_DTYPES or out_dtype not in OUT_DTYPES:
        raise TypeError(f"matmul takes inputs of {IN_DTYPES} and outputs of {OUT_DTYPES}, "
                        f"got {a.dtype} -> {out_dtype}")
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b, out_dtype)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if a.dtype == torch.float32:
        for name, t in (("a", a), ("b", b)):
            _util.check_cuda_operand(name, t, align=t.element_size())
        _util.launch("matmul", "repro_matmul", _ARGTYPES, a.device,
                     _util.DTYPE_CODES[a.dtype], _util.DTYPE_CODES[out_dtype],
                     a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k)
        return out
    if min(m, n, k) == 0:
        raise ValueError(f"the tensor-core kernel needs non-empty operands, got {m}x{k}x{n}")
    a = _tma_operand(a)
    b = transpose8(b) if a.element_size() == 1 else _tma_operand(b)
    _util.launch(TC_KERNELS[a.dtype], "repro_matmul_tc", _TC_ARGTYPES, a.device,
                 _util.DTYPE_CODES[a.dtype], _util.DTYPE_CODES[out_dtype], a.data_ptr(),
                 b.data_ptr(), out.data_ptr(), m, n, k, a.shape[1], b.shape[1], n)
    return out
