"""axpy kernel — the paper's Chapter-1 example.

The paper showed cublasSaxpy's 64-bit global loads leave ~2x bandwidth on the
table against 128-bit vectorized loads.  ``y + alpha*x`` is bound by bytes,
so the width of each access decides how much of the memory rate it reaches.
The kernel (``csrc/axpy.cu``) replaces the Pallas ``_axpy_kernel`` of
``repro/kernels/axpy.py``: one block per ``(block_rows, block_cols)`` tile as
in the TPU grid, every access ``vec_bytes`` (4, 8 or 16) wide, so a sweep over
``vec_bytes`` is the Fig 1.1 experiment stated directly.  Inside a tile each
thread issues the loads of ``AXPY_UNROLL`` vectors before it stores any, the
same number at every width; :func:`axpy_geometry` sets the launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _util, ref

_ARGTYPES = (
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int,
)
VEC_BYTES = (4, 8, 16)
AXPY_UNROLL = 4  # vectors a thread loads before it stores; csrc/axpy.cu::kUnroll
AXPY_MAX_THREADS = 1024


class AxpyGeometry(NamedTuple):
    """One launch of the axpy kernel: a block of ``threads`` per tile, each
    thread ``rounds`` rounds of ``unroll`` vectors spaced ``threads`` apart.
    The kernel takes ``threads`` and ``rounds``; ``unroll`` is its constant
    (:func:`kernel_unroll`)."""

    ctas: int
    threads: int
    unroll: int
    rounds: int


def axpy_geometry(shape, block_rows: int, block_cols: int, vec_bytes: int,
                  itemsize: int) -> AxpyGeometry:
    """The launch for an (R, C) array of ``itemsize``-byte elements in
    (block_rows, block_cols) tiles with ``vec_bytes``-wide accesses: threads
    ``min(1024, ceil(tile_vecs / unroll))`` rounded up to whole warps, and as
    many rounds as cover the tile's vectors; the last round's vectors past
    the tile are masked.  ``unroll`` is the same at every width."""
    rows, cols = shape
    tile_vecs = block_rows * block_cols * itemsize // vec_bytes
    per_round = -(-tile_vecs // AXPY_UNROLL)
    threads = min(AXPY_MAX_THREADS, -(-per_round // 32) * 32)
    rounds = -(-tile_vecs // (threads * AXPY_UNROLL))
    return AxpyGeometry((rows // block_rows) * (cols // block_cols), threads, AXPY_UNROLL, rounds)


def kernel_unroll(vec_bytes: int) -> int:
    """The unroll the built kernel runs at ``vec_bytes``, as it reports it
    (``csrc/axpy.cu::repro_axpy_unroll``); builds the library on first use."""
    fn = _util.library().repro_axpy_unroll
    fn.argtypes, fn.restype = (ctypes.c_int,), ctypes.c_int
    return fn(vec_bytes)


def axpy_cuda(
    x: torch.Tensor,
    y: torch.Tensor,
    alpha: float,
    *,
    block_rows: int = 8,
    block_cols: int = 512,
    vec_bytes: int = 16,
) -> torch.Tensor:
    """x, y: (R, C) with R % block_rows == 0 and C % block_cols == 0.

    On CUDA tensors this launches the kernel; CPU tensors take the plain
    version.
    """
    if x.shape != y.shape or x.dtype != y.dtype or x.ndim != 2:
        raise ValueError(f"x, y must be 2-D of one shape and dtype: {x.shape} {y.shape}")
    if x.dtype not in _util.DTYPE_CODES:
        raise TypeError(f"axpy takes float32/bfloat16/float16, got {x.dtype}")
    r, c = x.shape
    if r % block_rows or c % block_cols:
        raise ValueError(f"shape {(r, c)} does not divide into ({block_rows}, {block_cols}) tiles")
    if vec_bytes not in VEC_BYTES or (block_cols * x.element_size()) % vec_bytes:
        raise ValueError(f"vec_bytes must be one of {VEC_BYTES} and divide a tile row")
    if x.device.type == "cpu":
        return ref.axpy_ref(x, y, alpha)
    for name, t in (("x", x), ("y", y)):
        _util.check_cuda_operand(name, t)
    out = torch.empty_like(x)
    # alpha rounded to x's dtype, as the reference rounds it (c_float rounds float32)
    alpha_t = alpha if x.dtype == torch.float32 else torch.tensor(alpha, dtype=x.dtype).item()
    geo = axpy_geometry((r, c), block_rows, block_cols, vec_bytes, x.element_size())
    _util.launch("axpy", "repro_axpy", _ARGTYPES, x.device,
                 _util.DTYPE_CODES[x.dtype], vec_bytes, alpha_t, x.data_ptr(), y.data_ptr(),
                 out.data_ptr(), r, c, block_rows, block_cols, geo.threads, geo.rounds)
    return out
