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


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


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


def ssm_scan_chunked_ref(u, a_log, b, c, chunk: int):
    """The chunked SSD math of the reference's Pallas ``_ssd_kernel``, in fp32:
    the ``ssm_scan`` kernel's plain version.  u (BH,S,P); a_log (BH,S); b/c
    (BH,S,N); S % chunk == 0.  The state starts at zero; y has u's dtype."""
    bh, s, p = u.shape
    if s % chunk:
        raise ValueError(f"S {s} does not divide into chunk {chunk}")
    uf, af, bf, cf = u.float(), a_log.float(), b.float(), c.float()
    h = torch.zeros((bh, p, b.shape[-1]), dtype=torch.float32, device=u.device)
    tri = torch.ones((chunk, chunk), device=u.device).tril()
    ys = []
    for t0 in range(0, s, chunk):
        uj, bj, cj = uf[:, t0:t0 + chunk], bf[:, t0:t0 + chunk], cf[:, t0:t0 + chunk]
        acum = torch.cumsum(af[:, t0:t0 + chunk], dim=1)  # (BH, L)
        atot = acum[:, -1:]
        # intra-chunk: the decay-masked (C.B^T) score matrix
        dd = acum[:, :, None] - acum[:, None, :]
        w = (cj @ bj.transpose(1, 2)) * torch.exp(dd.clamp(-60.0, 0.0)) * tri
        # inter-chunk: the carried state's term
        y_inter = (cj @ h.transpose(1, 2)) * torch.exp(acum)[..., None]
        ys.append(w @ uj + y_inter)
        sdecay = torch.exp((atot - acum).clamp(-60.0, 0.0))  # (BH, L)
        h = h * torch.exp(atot)[..., None] + (uj * sdecay[..., None]).transpose(1, 2) @ bj
    return torch.cat(ys, dim=1).to(u.dtype)
