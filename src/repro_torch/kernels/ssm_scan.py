"""Chunked SSD (Mamba2) scan, on two routes.

The kernels (``csrc/ssm_scan.cu``) replace the Pallas ``_ssd_kernel`` of
``repro/kernels/ssm_scan.py``.  :func:`tc_route` picks one:

* ``wgmma`` (bf16 with P and N multiples of 16 up to 128, any chunk):
  the state-passing form of SSD on the tensor cores, three launches.  Pass 1
  writes each chunk's own state and the cumulative decay into fp32 scratch
  the wrapper allocates, pass 2 turns the chunk states into the states
  entering each chunk, in place, and pass 3 writes y from them, one block per
  64-row tile of a chunk.  Each pass has a plain version in
  :mod:`~repro_torch.kernels.ref` (``ssd_chunk_states``, ``ssd_pass_states``,
  ``ssd_chunk_outputs``) and a wrapper of its own here, for the card's checks.
* ``simt`` (fp32, fp16, and P or N past 128 or off the multiples of 16): one
  (batch, head, slice of up to 128 columns of P) per block on the FP32
  pipes, its slice of the state carried across the chunks in shared memory;
  P > 128 splits over the grid, N > 128 runs the scan once per slab of 128
  and sums y in an fp32 scratch.  Tensor cores keep neither fp32's precision
  nor widths off 16 bytes.  fp16 stays here too: the wgmma route feeds the
  state h and the weights W to the tensor cores as 16-bit hi + lo pairs of
  the input type, and fp16's range ends at 65,504, where the reference's
  fp32 state goes on; bf16 has fp32's range.  The passes' own wrappers
  below still take fp16, for the card's checks of each pass.

The launch counts as one ``ssm_scan`` launch whatever the route;
``_util.route_counts()["ssm_scan"]`` says which route it took.
"""
from __future__ import annotations

import ctypes

import torch

from . import _util, ref

DIM_TILE = 128  # columns of P a block, and values of N a slab (csrc kDimTile)
ROW_TILE = 64  # rows of a tile: acum holds ceil(chunk / 64) * 64 entries
TC_DTYPES = (torch.bfloat16,)  # the scan's wgmma route
PASS_DTYPES = (torch.bfloat16, torch.float16)  # what the pass kernels compute
_P = ctypes.c_void_p
_I = ctypes.c_int
# dtype, u, a, b, c, y, then two scratch pointers, batch, S, H, P, N, chunk: both routes
_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I)
_STATES_ARGTYPES = (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I)
_PASS_ARGTYPES = (_P, _P, _I, _I, _I, _I, _I, _I)
_OUTPUTS_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I)


def _tc_widths(p: int, n: int) -> bool:
    """P and N multiples of 16 up to 128 (wgmma's 16-byte steps, the kernels'
    64- and 128-wide instances)."""
    return all(0 < d <= DIM_TILE and d % 16 == 0 for d in (p, n))


def tc_route(dtype: torch.dtype, p: int, n: int) -> bool:
    """Whether the scan takes the ``wgmma`` route for these operands: bf16
    with P and N multiples of 16 up to 128."""
    return dtype in TC_DTYPES and _tc_widths(p, n)


def _check(u, a_shape, b, c, chunk):
    if u.ndim != 4 or a_shape != u.shape[:3] or b.ndim != 3 or c.shape != b.shape:
        raise ValueError(f"need u (B,S,H,P), a_log (B,S,H), b/c (B,S,N), got {tuple(u.shape)}, "
                         f"{tuple(a_shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    if b.shape[:2] != u.shape[:2]:
        raise ValueError(f"b/c {tuple(b.shape)} do not match u {tuple(u.shape)}")
    if chunk < 1 or u.shape[1] % chunk:
        raise ValueError(f"S {u.shape[1]} does not divide into chunk {chunk}")
    if b.dtype != u.dtype or c.dtype != u.dtype:
        raise TypeError(f"u, b, c must share a dtype, got {u.dtype}, {b.dtype}, {c.dtype}")


def _tc_operands(*ts):
    """The tensor-core route's operands: contiguous, and 16-byte aligned as the
    TMA needs (a view at an odd offset is copied, not refused)."""
    out = []
    for name, t in ts:
        if t.data_ptr() % 16:
            t = t.clone()
        _util.check_cuda_operand(name, t, align=16)
        out.append(t)
    return out


def _tc_scratch(u, n, chunk):
    """fp32 chunk states (B, H, S / chunk, P, N) and acum (B, H, S)."""
    bsz, s, h, p = u.shape
    states = torch.empty((bsz, h, s // chunk, p, n), dtype=torch.float32, device=u.device)
    return states, torch.empty((bsz, h, s), dtype=torch.float32, device=u.device)


def _dims(u, n, chunk):
    bsz, s, h, p = u.shape
    return bsz, s, h, p, n, chunk


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
    kernel of :func:`tc_route`'s route; CPU tensors take the plain version,
    :func:`repro_torch.kernels.ref.ssm_scan_chunked_ref`.
    """
    _check(u, a_log.shape, b, c, chunk)
    bsz, s, h, p = u.shape
    n = b.shape[-1]
    a_log = a_log.float()
    if u.device.type == "cpu":
        y = ref.ssm_scan_chunked_ref(*_util.flatten_ssm(u, a_log, b, c), chunk)
        return _util.unflatten_heads(y, bsz)
    if u.dtype not in _util.FLOAT_DTYPES:
        raise TypeError(f"ssm_scan kernel takes float32/bfloat16/float16, got {u.dtype}")
    code = _util.DTYPE_CODES[u.dtype]
    if tc_route(u.dtype, p, n):
        _util.check_cuda_operand("a_log", a_log, align=4)
        u, b, c = _tc_operands(("u", u), ("b", b), ("c", c))
        y = torch.empty_like(u)
        states, acum = _tc_scratch(u, n, chunk)
        _util.launch("ssm_scan", "repro_ssm_scan_tc", _ARGTYPES, u.device, code, u.data_ptr(),
                     a_log.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                     states.data_ptr(), acum.data_ptr(), *_dims(u, n, chunk), route="wgmma")
        return y
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
    _util.launch("ssm_scan", "repro_ssm_scan", _ARGTYPES, u.device, code,
                 u.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                 0 if yacc is None else yacc.data_ptr(), 0 if acum is None else acum.data_ptr(),
                 *_dims(u, n, chunk), route="simt")
    return y


# ---------------------------------------------------------------------------
# the wgmma route's passes one at a time (the card's checks of each pass)
# ---------------------------------------------------------------------------
def _tc_only(u, n):
    if u.dtype not in PASS_DTYPES or not _tc_widths(u.shape[-1], n):
        raise ValueError(f"the wgmma passes take bf16/fp16 with P, N multiples of 16 up to "
                         f"{DIM_TILE}, got {u.dtype}, P {u.shape[-1]}, N {n}")


def ssd_chunk_states_cuda(u, a_log, b, *, chunk: int = 256):
    """Pass 1: (states (B,H,nc,P,N), acum (B,H,S)), both fp32, as
    :func:`ref.ssd_chunk_states` computes them (its version on CPU tensors)."""
    _check(u, a_log.shape, b, b, chunk)
    a_log = a_log.float()
    if u.device.type == "cpu":
        return ref.ssd_chunk_states(u, a_log, b, chunk)
    n = b.shape[-1]
    _tc_only(u, n)
    _util.check_cuda_operand("a_log", a_log, align=4)
    u, b = _tc_operands(("u", u), ("b", b))
    states, acum = _tc_scratch(u, n, chunk)
    _util.launch("ssd_chunk_states", "repro_ssd_chunk_states", _STATES_ARGTYPES, u.device,
                 _util.DTYPE_CODES[u.dtype], u.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                 states.data_ptr(), acum.data_ptr(), *_dims(u, n, chunk))
    return states, acum


def ssd_pass_states_cuda(states, acum, *, chunk: int = 256):
    """Pass 2, in place on ``states``: the states entering each chunk, as
    :func:`ref.ssd_pass_states` returns them (its version on CPU tensors,
    which returns a new tensor)."""
    bsz, h, nc, p, n = states.shape
    if acum.shape != (bsz, h, nc * chunk):
        raise ValueError(f"acum {tuple(acum.shape)} does not match states {tuple(states.shape)}")
    if states.device.type == "cpu":
        return ref.ssd_pass_states(states, acum, chunk)[0]
    if not _tc_widths(p, n) or states.dtype != torch.float32:
        raise ValueError(f"states must be fp32 with P, N multiples of 16 up to {DIM_TILE}")
    for name, t in (("states", states), ("acum", acum)):
        _util.check_cuda_operand(name, t)
    _util.launch("ssd_pass_states", "repro_ssd_pass_states", _PASS_ARGTYPES, states.device,
                 states.data_ptr(), acum.data_ptr(), bsz, nc * chunk, h, p, n, chunk)
    return states


def ssd_chunk_outputs_cuda(u, b, c, entering, acum, *, chunk: int = 256):
    """Pass 3: y (B,S,H,P) in u's dtype from the states entering each chunk,
    as :func:`ref.ssd_chunk_outputs` computes it in fp32 (its version, cast,
    on CPU tensors)."""
    _check(u, u.shape[:3], b, c, chunk)
    bsz, s, h, p = u.shape
    if acum.shape != (bsz, h, s) or entering.shape != (bsz, h, s // chunk, p, b.shape[-1]):
        raise ValueError(f"entering {tuple(entering.shape)} or acum {tuple(acum.shape)} do not "
                         f"match u {tuple(u.shape)}")
    if u.device.type == "cpu":
        return ref.ssd_chunk_outputs(u, b, c, entering, acum, chunk).to(u.dtype)
    n = b.shape[-1]
    _tc_only(u, n)
    for name, t in (("entering", entering), ("acum", acum)):
        _util.check_cuda_operand(name, t)
    u, b, c = _tc_operands(("u", u), ("b", b), ("c", c))
    y = torch.empty_like(u)
    _util.launch("ssd_chunk_outputs", "repro_ssd_chunk_outputs", _OUTPUTS_ARGTYPES, u.device,
                 _util.DTYPE_CODES[u.dtype], u.data_ptr(), b.data_ptr(), c.data_ptr(),
                 y.data_ptr(), entering.data_ptr(), acum.data_ptr(), *_dims(u, n, chunk))
    return y
