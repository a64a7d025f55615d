"""Tiled matmul kernel — the §4.4 arithmetic-throughput probe.

The kernel (``csrc/matmul.cu``) replaces the Pallas ``_matmul_kernel`` of
``repro/kernels/matmul.py``.  It is bound by operations on the FP32 pipes
(67 TFLOP/s), and stays there: the ``dissect`` fit reads its rate as the
card's fp32 peak, so no TF32 and no tensor-core emulation.  What holds such a
kernel back is feeding the FMAs, so each block of 256 threads owns a 128x256
output tile with an 8x16 fp32 accumulator per thread and streams K through a
4-stage ring in shared memory: B by ``cp.async`` copies, A by 16-byte loads
written transposed, stage k+3 in flight while stage k's FMAs run.  Any M, N,
K runs (zero-filled edges; rows that are not 16-byte aligned take a
one-element-load instance of the same kernel).  bf16/fp16 inputs are widened
to fp32 as they are read from shared memory; their tensor-core path, and
int8/fp8, wait for the gemm_lp slice.

The reference's ``saturation_check`` guard sentinel waits for the port of
``kernels/guard.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _util, ref

_ARGTYPES = (
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
)


def matmul_cuda(
    a: torch.Tensor, b: torch.Tensor, *, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """a (M,K) @ b (K,N) with fp32 accumulation, cast to ``out_dtype``
    (default a's dtype).  Any M, N, K.  On CUDA tensors this launches the
    kernel; CPU tensors take the plain version."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul needs (M,K) @ (K,N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    for dt in (a.dtype, b.dtype, out_dtype):
        if dt not in _util.DTYPE_CODES:
            raise TypeError(
                f"matmul kernel takes float32/bfloat16/float16, got {dt} "
                "(int8 and fp8 wait for the gemm_lp slice)"
            )
    if a.dtype != b.dtype:
        raise TypeError(f"a and b must share a dtype, got {a.dtype} and {b.dtype}")
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b, out_dtype)
    for name, t in (("a", a), ("b", b)):
        _util.check_cuda_operand(name, t, align=t.element_size())
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _util.launch("matmul", "repro_matmul", _ARGTYPES, a.device,
                 _util.DTYPE_CODES[a.dtype], _util.DTYPE_CODES[out_dtype],
                 a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k)
    return out
