"""Pointer-chase kernel — the paper's core §3 methodology (Mei & Chu [9]).

A permutation array is walked with fully dependent loads: ``idx = perm[idx]``.
Time / steps = dependent-load latency at the hierarchy level holding the
array: on the H100, L1 (256 KB per SM), L2 (50 MB) or HBM.

The kernel (``csrc/pchase.cu``) replaces the Pallas ``_pchase_kernel`` of
``repro/kernels/pchase.py``.  It is bound by load latency, not by bytes, and
runs the walk in one thread of one block so that nothing overlaps the chain;
the source note there says how the load is kept on the cached path.
"""
from __future__ import annotations

import ctypes

import torch

from . import _util

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p)


def pchase_torch(perm: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version: the same walk with tensor indexing, on perm's device."""
    idx = torch.zeros((), dtype=torch.int64, device=perm.device)
    for _ in range(steps):
        idx = perm[idx]
    return idx.to(torch.int32).reshape(1, 1)


def pchase_cuda(perm: torch.Tensor, steps: int) -> torch.Tensor:
    """perm: (N,) int32 permutation of range(N).  Returns the final index (1,1).

    On a CUDA tensor this launches the kernel; a CPU tensor takes the plain
    version.
    """
    if perm.ndim != 1 or perm.dtype != torch.int32:
        raise TypeError(f"perm must be a 1-D int32 tensor, got {tuple(perm.shape)} {perm.dtype}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if perm.device.type == "cpu":
        return pchase_torch(perm, steps)
    _util.check_cuda_operand("perm", perm, align=4)
    out = torch.empty((1, 1), dtype=torch.int32, device=perm.device)
    _util.launch("pchase", "repro_pchase", _ARGTYPES, perm.device,
                 perm.data_ptr(), steps, out.data_ptr())
    return out
