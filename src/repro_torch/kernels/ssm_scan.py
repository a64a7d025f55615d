"""Chunked SSD (Mamba2) scan: one (batch, head, slice of up to 128 columns of
P) per block, its slice of the state carried across the chunks in shared
memory.

The kernel (``csrc/ssm_scan.cu``) replaces the Pallas ``_ssd_kernel`` of
``repro/kernels/ssm_scan.py``.  One block of 256 threads loops over the
chunks of one (batch, head); y is computed in 64-row tiles, each over the key
tiles at or below the diagonal, and the state update follows once every row
tile has read the old state.  Any chunk that divides S runs (the cumulative
decay is scanned 256 steps at a time with a carry), and any P and N: P > 128
splits over the grid, N > 128 runs the scan once per slab of 128 and sums y
in an fp32 scratch.  All arithmetic is fp32 on the FP32 pipes; at zamba2-7b's
shape it is bound by bytes, and ``wgmma`` is later work (ROADMAP.md).
"""
from __future__ import annotations

import ctypes

import torch

from . import _util, ref

DIM_TILE = 128  # columns of P a block, and values of N a slab (csrc kDimTile)
ROW_TILE = 64  # rows of a tile: acum holds ceil(chunk / 64) * 64 entries
_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
)


def ssm_scan_cuda(u: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                  chunk: int = 256) -> torch.Tensor:
    """u (B, S, H, P); a_log (B, S, H); b/c (B, S, N), shared by the heads.

    Unlike ``ssm_scan_pallas``, which takes the head-flattened (BH, S, .)
    layout with B and C expanded per head, this takes the model's layout,
    so B and C are never copied H times.  S must divide into ``chunk``
    (``kernels.api.ssm_scan`` pads it), as the reference asserts; any chunk,
    P and N run.
    u, b and c share a float32/bfloat16/float16 dtype; a_log is taken in
    float32, as the reference's kernel casts it.  Returns y (B, S, H, P) in
    u's dtype, from a zero initial state.  On CUDA tensors this launches the
    kernel; CPU tensors take the plain version,
    :func:`repro_torch.kernels.ref.ssm_scan_chunked_ref`.
    """
    if u.ndim != 4 or a_log.shape != u.shape[:3] or b.ndim != 3 or c.shape != b.shape:
        raise ValueError(f"need u (B,S,H,P), a_log (B,S,H), b/c (B,S,N), got {tuple(u.shape)}, "
                         f"{tuple(a_log.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    bsz, s, h, p = u.shape
    n = b.shape[-1]
    if b.shape[:2] != (bsz, s):
        raise ValueError(f"b/c {tuple(b.shape)} do not match u {tuple(u.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"S {s} does not divide into chunk {chunk}")
    if b.dtype != u.dtype or c.dtype != u.dtype:
        raise TypeError(f"u, b, c must share a dtype, got {u.dtype}, {b.dtype}, {c.dtype}")
    a_log = a_log.float()
    if u.device.type == "cpu":
        y = ref.ssm_scan_chunked_ref(*_util.flatten_ssm(u, a_log, b, c), chunk)
        return _util.unflatten_heads(y, bsz)
    if u.dtype not in _util.FLOAT_DTYPES:
        raise TypeError(f"ssm_scan kernel takes float32/bfloat16/float16, got {u.dtype}")
    for name, t in (("u", u), ("a_log", a_log), ("b", b), ("c", c)):
        _util.check_cuda_operand(name, t, align=t.element_size())
    y = torch.empty_like(u)
    # N past one slab: y summed over the slabs in fp32
    yacc = torch.empty(u.shape, dtype=torch.float32, device=u.device) if n > DIM_TILE else None
    acum = None
    if not _util.library().repro_ssm_scan_acum_fits(p, n, chunk):
        blocks = bsz * h * -(-p // DIM_TILE)
        acum = torch.empty(blocks * -(-chunk // ROW_TILE) * ROW_TILE, dtype=torch.float32,
                           device=u.device)
    _util.launch("ssm_scan", "repro_ssm_scan", _ARGTYPES, u.device, _util.DTYPE_CODES[u.dtype],
                 u.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                 0 if yacc is None else yacc.data_ptr(), 0 if acum is None else acum.data_ptr(),
                 bsz, s, h, p, n, chunk)
    return y
