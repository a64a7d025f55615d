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
from collections import OrderedDict

import torch

from . import _util

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p)
#: steps of the plain walk captured in one CUDA graph, replayed on the card
GRAPH_STEPS = 256
_GRAPH_CACHE = 4  # captured walks kept, the least recently used dropped first
_graphs: OrderedDict = OrderedDict()


def _walk(perm: torch.Tensor, idx: torch.Tensor, steps: int) -> torch.Tensor:
    for _ in range(steps):
        idx = torch.index_select(perm, 0, idx)
    return idx


def _walk_graph(perm: torch.Tensor) -> tuple:
    """(graph, idx): ``GRAPH_STEPS`` steps of the walk from ``idx`` back into
    ``idx``, captured once for a permutation's address and layout.  The
    graph reads whatever lies at that address when it is replayed, so a new
    permutation of the same size there walks correctly."""
    key = (perm.device, perm.data_ptr(), perm.numel(), perm.stride(0), perm.dtype, GRAPH_STEPS)
    hit = _graphs.pop(key, None)
    if hit is None:
        idx = torch.zeros((1,), dtype=torch.int64, device=perm.device)
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(perm.device)
        side.wait_stream(torch.cuda.current_stream(perm.device))
        with torch.cuda.stream(side):
            graph.capture_begin()
            idx.copy_(_walk(perm, idx, GRAPH_STEPS))
            graph.capture_end()
        torch.cuda.current_stream(perm.device).wait_stream(side)
        hit = (graph, idx)
    _graphs[key] = hit
    while len(_graphs) > _GRAPH_CACHE:
        _graphs.popitem(last=False)
    return hit


def pchase_torch(perm: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version: the same walk, one ``index_select`` a step, on perm's
    device.  On the card the steps run as replays of a CUDA graph of
    ``GRAPH_STEPS`` of them, captured on the first call for this
    permutation, so the walk's time is the device's: one eager launch a step,
    or a capture inside every call, would leave it at the host's pace, which
    varies from host to host."""
    blocks, rest = divmod(steps, GRAPH_STEPS) if perm.is_cuda else (0, steps)
    if blocks:
        graph, idx = _walk_graph(perm)
        idx.zero_()
        for _ in range(blocks):
            graph.replay()
    else:
        idx = torch.zeros((1,), dtype=torch.int64, device=perm.device)
    return _walk(perm, idx, rest).to(torch.int32).reshape(1, 1)


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
