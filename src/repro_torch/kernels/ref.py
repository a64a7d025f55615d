"""Plain PyTorch versions of every kernel's function: the oracles the kernels
are tested against, in the same argument layouts as ``repro.kernels.ref``.
They run on any device, the card included."""
from __future__ import annotations

import numpy as np
import torch


def axpy_ref(x: torch.Tensor, y: torch.Tensor, alpha) -> torch.Tensor:
    # alpha is rounded to x's dtype first, as the reference's jnp.asarray(alpha, x.dtype)
    a = torch.tensor(alpha, dtype=x.dtype).item()
    return a * x + y


def copy_ref(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def reduce_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.float()).reshape(1, 1)


def strided_reduce_ref(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The reference's oracle: every ``stride``-th row of the whole array."""
    return torch.sum(x[::stride, :].float()).reshape(1, 1)


def strided_reduce_blocked_ref(x: torch.Tensor, stride: int, block_rows: int) -> torch.Tensor:
    """What the reference's Pallas kernel sums: the rows whose offset within
    their ``block_rows`` block is a multiple of ``stride`` (the stride
    restarts in every block).  Equal to :func:`strided_reduce_ref` whenever
    ``stride`` divides ``block_rows``."""
    rows = torch.arange(x.shape[0], device=x.device)
    return torch.sum(x[(rows % block_rows) % stride == 0].float()).reshape(1, 1)


def pchase_ref(perm, steps: int) -> int:
    arr = perm.tolist() if isinstance(perm, torch.Tensor) else np.asarray(perm).tolist()
    idx = 0
    for _ in range(steps):
        idx = arr[idx]
    return int(idx)


FP8_E4M3_NAN_PAST = 464.0  # the midpoint of 448 and 480: past it, XLA's e4m3fn cast gives NaN


def cast_like_xla(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as the reference (XLA) casts a float array, where
    torch's ``.to`` differs: to an integer type it truncates toward zero and
    saturates at the type's range (NaN gives 0; torch wraps), and to fp8
    e4m3fn it rounds to nearest even and gives NaN for every value past
    448's rounding range and for inf (torch saturates to 448)."""
    if dtype in (torch.int8, torch.int32):
        info = torch.iinfo(dtype)
        x = torch.nan_to_num(x.double().trunc(), nan=0.0)
        return x.clamp(info.min, info.max).to(dtype)
    if dtype == torch.float8_e4m3fn:
        y = x.to(dtype)
        nan = torch.full_like(y, float("nan"))
        return torch.where(x.abs() <= FP8_E4M3_NAN_PAST, y, nan)
    return x.to(dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """a @ b accumulated in fp32 and cast to ``out_dtype`` (default a's) with
    :func:`cast_like_xla`: the reference's ``matmul_ref`` and its kernel's
    ``acc.astype(o_ref.dtype)``, for every input type (int8 in fp32 too, exact
    while every partial sum stays below 2^24)."""
    out_dtype = out_dtype or a.dtype
    return cast_like_xla(torch.matmul(a.float(), b.float()), out_dtype)


def transpose8_ref(b: torch.Tensor, rows: int) -> torch.Tensor:
    """B (K, N) of a 1-byte type -> B^T (N, rows), zero past K: the 8-bit
    matmul's transpose pass."""
    k = b.shape[0]
    bt = torch.nn.functional.pad(b.t().view(torch.uint8), (0, rows - k))
    return bt.view(b.dtype).contiguous()


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, q_offset: int = 0,
    kv_len: int | None = None, scale: float | None = None,
) -> torch.Tensor:
    """q (BH, Sq, hd); k/v (BH, Skv, hd).  ``kv_len`` masks keys from that
    index on (the padding the kernel wrapper adds); None keeps every key.
    ``scale`` multiplies the scores, ``hd ** -0.5`` when None; the kernel
    wrapper passes the true head width's when it zero-pads hd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) * scale
    sq, skv = s.shape[-2], s.shape[-1]
    ki = torch.arange(skv, device=q.device)[None, :]
    if causal:
        qi = q_offset + torch.arange(sq, device=q.device)[:, None]
        s = torch.where(ki <= qi, s, torch.full_like(s, -1e30))
    if kv_len is not None and kv_len < skv:
        s = torch.where(ki < kv_len, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)


def ssm_scan_ref(u, a_log, b, c):
    """Sequential SSD recurrence.  u (BH,S,P); a_log (BH,S); b/c (BH,S,N).
    The ``torch`` backend of ``ssm_scan``: the reference's ``xla`` oracle."""
    bh, s, p = u.shape
    n = b.shape[-1]
    uf, af, bf, cf = u.float(), a_log.float(), b.float(), c.float()
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=u.device)
    ys = []
    for t in range(s):
        h = h * torch.exp(af[:, t])[:, None, None] + uf[:, t, :, None] * bf[:, t, None, :]
        ys.append(torch.einsum("bpn,bn->bp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(u.dtype)


def ssd_chunk_states(u, a_log, b, chunk: int):
    """Pass 1 of the chunked SSD scan: each chunk's own state, from a zero
    state at its start.  u (B,S,H,P); a_log (B,S,H); b (B,S,N), shared by
    the heads; S % chunk == 0.  Returns ``states`` (B,H,nc,P,N) fp32,
    sum_s exp(clip(atot - acum_s, -60, 0)) u_s b_s^T over each chunk, and
    ``acum`` (B,H,S) fp32, the cumulative sum of a_log within each chunk
    (atot is its last entry)."""
    bsz, s, h, p = u.shape
    if s % chunk:
        raise ValueError(f"S {s} does not divide into chunk {chunk}")
    nc, n = s // chunk, b.shape[-1]
    acum = torch.cumsum(a_log.float().reshape(bsz, nc, chunk, h), dim=2)  # (B,nc,L,H)
    sdecay = torch.exp((acum[:, :, -1:] - acum).clamp(-60.0, 0.0))
    us = u.float().reshape(bsz, nc, chunk, h, p) * sdecay[..., None]
    states = torch.einsum("bclhp,bcln->bhcpn", us, b.float().reshape(bsz, nc, chunk, n))
    return states.contiguous(), acum.permute(0, 3, 1, 2).reshape(bsz, h, s).contiguous()


def ssd_pass_states(states, acum, chunk: int, h0=None):
    """Pass 2: the state entering each chunk, h_0 = h0 (zero when None) and
    h_{c+1} = h_c exp(atot_c) + states_c.  states (B,H,nc,P,N); acum (B,H,S)
    from :func:`ssd_chunk_states`; h0 (B,H,P,N).  Returns (``entering``
    (B,H,nc,P,N) fp32, ``h_final`` (B,H,P,N), the state after the last
    chunk)."""
    decay = torch.exp(acum[..., chunk - 1::chunk])  # (B,H,nc): exp(atot) of each chunk
    h = torch.zeros_like(states[:, :, 0]) if h0 is None else h0.float()
    entering = []
    for c in range(states.shape[2]):
        entering.append(h)
        h = h * decay[:, :, c, None, None] + states[:, :, c]
    return torch.stack(entering, dim=2), h


def ssd_chunk_outputs(u, b, c, entering, acum, chunk: int):
    """Pass 3: y (B,S,H,P) fp32 from each chunk's inputs and the state
    entering it: the decay-masked (C.B^T) scores times u, plus
    exp(acum_t) (C_t . h).  u (B,S,H,P); b/c (B,S,N); entering
    (B,H,nc,P,N) and acum (B,H,S) from passes 1 and 2."""
    bsz, s, h, p = u.shape
    nc, n = s // chunk, b.shape[-1]
    bf, cf = (x.float().reshape(bsz, nc, chunk, n) for x in (b, c))
    ac = acum.reshape(bsz, h, nc, chunk)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=u.device).tril()
    dd = (ac[..., :, None] - ac[..., None, :]).clamp(-60.0, 0.0)  # (B,H,nc,L,L): t, s
    w = torch.einsum("bctn,bcsn->bcts", cf, bf)[:, None] * torch.exp(dd) * tri
    y = torch.einsum("bhcts,bcshp->bcthp", w, u.float().reshape(bsz, nc, chunk, h, p))
    y_inter = torch.einsum("bctn,bhcpn->bcthp", cf, entering)
    y = y + y_inter * torch.exp(ac).permute(0, 2, 3, 1)[..., None]
    return y.reshape(bsz, s, h, p)


def ssd_chunked_ref(u, a_log, b, c, chunk: int, h0=None):
    """The three passes composed: (y (B,S,H,P) fp32, h_final (B,H,P,N))
    from the state h0 (zero when None).  The model layout of
    :func:`ssd_chunk_states`; S % chunk == 0."""
    states, acum = ssd_chunk_states(u, a_log, b, chunk)
    entering, h_final = ssd_pass_states(states, acum, chunk, h0)
    return ssd_chunk_outputs(u, b, c, entering, acum, chunk), h_final


def ssm_scan_chunked_ref(u, a_log, b, c, chunk: int):
    """The chunked SSD math of the reference's Pallas ``_ssd_kernel``, in fp32:
    the ``ssm_scan`` kernel's plain version.  u (BH,S,P); a_log (BH,S); b/c
    (BH,S,N); S % chunk == 0.  The state starts at zero; y has u's dtype.
    :func:`ssd_chunked_ref` with each (batch, head) a batch row of one head."""
    y, _ = ssd_chunked_ref(u[:, :, None], a_log[:, :, None], b, c, chunk)
    return y[:, :, 0].to(u.dtype)
