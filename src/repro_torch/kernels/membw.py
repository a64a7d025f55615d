"""Streaming-bandwidth probe kernels (paper §3.1/3.2/3.7 analogue).

``stream_copy``: HBM->SM->HBM round trip (the write-allocate path).
``stream_reduce``: read-only scan accumulating a checksum — the analogue of
the paper's l1_bw/l2_bw read benchmarks (the checksum plays the role of the
paper's ``dsink``).
``strided_reduce``: the sum of one row in every ``stride`` rows of each block
of ``block_rows`` rows — the load-granularity probe (paper Tab 3.1).

Their kernels (``csrc/membw.cu``) replace the Pallas ``_copy_kernel``,
``_reduce_kernel`` and ``_strided_reduce_kernel`` of ``repro/kernels/membw.py``.
They are bound by bytes and read 16 bytes per access from enough blocks to
fill all SMs.  The reductions sum per-block partials in a second pass; each
thread of the copy issues the loads of two vectors before it stores either
(:func:`copy_plan` sets its grid).  On a CUDA tensor each wrapper launches its
kernel; a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _util, ref

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
_COPY_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
_STRIDED_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
)
_THREADS = 256  # csrc/membw.cu::kThreads
_BLOCKS_PER_SM = 8  # 2048 resident threads per SM / 256
COPY_THREADS = 128
COPY_UNROLL = 2  # 16-byte vectors a thread loads before it stores; csrc/membw.cu::kCopyUnroll
COPY_BLOCKS_PER_SM = 128  # 8 waves of the 16 blocks of 128 threads an SM holds
COPY_ROUND_BYTES = COPY_THREADS * COPY_UNROLL * 16  # one block's round


class CopyPlan(NamedTuple):
    """One launch of the copy kernel: ``ctas`` blocks of ``threads`` take
    rounds of ``threads * unroll`` 16-byte vectors of the first
    ``bulk_bytes`` in a grid stride (block b rounds b, b + ctas, ...), each
    thread ``unroll`` vectors a round; the last block's threads copy the
    ``tail_bytes`` after them.  The kernel takes ``ctas`` and ``threads``;
    the unroll is its constant and the split into bulk and tail follows
    from the size."""

    ctas: int
    threads: int
    unroll: int
    bulk_bytes: int
    tail_bytes: int


def copy_plan(nbytes: int, sms: int) -> CopyPlan:
    """The copy of ``nbytes`` on a card of ``sms`` SMs: every whole 16 bytes
    in rounds, one round a block up to 128 blocks an SM, then grid-stride."""
    bulk = nbytes - nbytes % 16
    rounds = -(-bulk // COPY_ROUND_BYTES)
    ctas = max(1, min(rounds, COPY_BLOCKS_PER_SM * sms))
    return CopyPlan(ctas, COPY_THREADS, COPY_UNROLL, bulk, nbytes - bulk)


def _check_tiles(x: torch.Tensor, block_rows: int, block_cols: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    r, c = x.shape
    if r % block_rows or c % block_cols:
        raise ValueError(f"shape {(r, c)} does not divide into ({block_rows}, {block_cols}) tiles")


def _grid(x: torch.Tensor, work: int) -> int:
    """Blocks of 256 threads for ``work`` threads, at most 8 per SM."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return max(1, min(-(-work // _THREADS), sms * _BLOCKS_PER_SM))


def stream_copy(x: torch.Tensor, *, block_rows: int = 8, block_cols: int = 512) -> torch.Tensor:
    """Copy bandwidth probe: returns a new tensor equal to ``x`` bit for bit.

    ``block_rows``/``block_cols`` are the tile the shape must divide into, as
    in the reference; the kernel copies 16 bytes per thread access.
    """
    _check_tiles(x, block_rows, block_cols)
    if x.device.type == "cpu":
        return ref.copy_ref(x)
    _util.check_cuda_operand("x", x)
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    plan = copy_plan(nbytes, torch.cuda.get_device_properties(x.device).multi_processor_count)
    _util.launch("stream_copy", "repro_stream_copy", _COPY_ARGTYPES, x.device,
                 x.data_ptr(), nbytes, out.data_ptr(), plan.ctas, plan.threads)
    return out


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
    blocks = _grid(x, n // 4)
    partials = torch.empty(blocks, dtype=torch.float32, device=x.device)
    out = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    _util.launch("stream_reduce", "repro_stream_reduce", _ARGTYPES, x.device,
                 x.data_ptr(), n, partials.data_ptr(), blocks, out.data_ptr())
    return out


def strided_reduce(x: torch.Tensor, *, stride: int, block_rows: int = 64) -> torch.Tensor:
    """Load-granularity probe: the (1,1) fp32 sum of the rows whose offset
    within their block of ``block_rows`` rows is a multiple of ``stride``.

    That is what the reference's Pallas kernel sums (its stride restarts in
    every block); its oracle, ``x[::stride].sum()``, agrees only when
    ``stride`` divides ``block_rows`` (ROADMAP.md §3).
    """
    if x.ndim != 2 or x.shape[0] % block_rows:
        raise ValueError(f"rows of {tuple(x.shape)} do not divide into blocks of {block_rows}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if x.device.type == "cpu":
        return ref.strided_reduce_blocked_ref(x, stride, block_rows)
    if x.dtype != torch.float32:
        raise TypeError(f"strided_reduce kernel takes float32, got {x.dtype}")
    _util.check_cuda_operand("x", x)
    rows, cols = x.shape
    per = -(-block_rows // stride)  # selected rows in each block
    sel_rows = rows // block_rows * per
    blocks = _grid(x, sel_rows * 32)  # one warp per selected row
    partials = torch.empty(blocks, dtype=torch.float32, device=x.device)
    out = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    _util.launch("strided_reduce", "repro_strided_reduce", _STRIDED_ARGTYPES, x.device,
                 x.data_ptr(), sel_rows, cols, per, block_rows, stride, partials.data_ptr(),
                 blocks, out.data_ptr())
    return out
