"""Streaming-bandwidth probe kernels (paper §3.1/3.2/3.7 analogue).

``stream_reduce``: read-only scan accumulating a checksum — the analogue of
the paper's l1_bw/l2_bw read benchmarks (the checksum plays the role of the
paper's ``dsink``).  Its kernel (``csrc/membw.cu``) replaces the Pallas
``_reduce_kernel`` of ``repro/kernels/membw.py``; it is bound by bytes, and
reads with 16-byte loads from enough blocks to fill all SMs, then sums the
per-block partials in a second pass.

``stream_copy`` and ``strided_reduce`` have plain versions only so far; their
kernels are still to be ported, and a CUDA tensor raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _util, ref

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
_THREADS = 256  # csrc/membw.cu::kThreads
_BLOCKS_PER_SM = 8  # 2048 resident threads per SM / 256


def _check_tiles(x: torch.Tensor, block_rows: int, block_cols: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    r, c = x.shape
    if r % block_rows or c % block_cols:
        raise ValueError(f"shape {(r, c)} does not divide into ({block_rows}, {block_cols}) tiles")


def _no_kernel(op: str, x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"{op} has no CUDA kernel yet (queued in ROADMAP.md); use backend='torch'"
        )


def stream_copy(x: torch.Tensor, *, block_rows: int = 8, block_cols: int = 512) -> torch.Tensor:
    _check_tiles(x, block_rows, block_cols)
    _no_kernel("stream_copy", x)
    return ref.copy_ref(x)


def stream_reduce(x: torch.Tensor, *, block_rows: int = 8, block_cols: int = 512) -> torch.Tensor:
    """Read-bandwidth probe: returns the (1,1) fp32 checksum.

    ``block_rows``/``block_cols`` are the tile the shape must divide into, as
    in the reference; the kernel picks its own CTA tile.  On a CUDA tensor
    this launches the kernel; a CPU tensor takes the plain version.
    """
    _check_tiles(x, block_rows, block_cols)
    if x.dtype != torch.float32:
        raise TypeError(f"stream_reduce takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return ref.reduce_ref(x)
    _util.check_cuda_operand("x", x)
    n = x.numel()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(-(-(n // 4) // _THREADS), sms * _BLOCKS_PER_SM))
    partials = torch.empty(blocks, dtype=torch.float32, device=x.device)
    out = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    _util.launch("stream_reduce", "repro_stream_reduce", _ARGTYPES, x.device,
                 x.data_ptr(), n, partials.data_ptr(), blocks, out.data_ptr())
    return out


def strided_reduce(x: torch.Tensor, *, stride: int, block_rows: int = 64) -> torch.Tensor:
    if x.ndim != 2 or x.shape[0] % block_rows:
        raise ValueError(f"rows of {tuple(x.shape)} do not divide into blocks of {block_rows}")
    _no_kernel("strided_reduce", x)
    return ref.strided_reduce_ref(x, stride)
