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
    return torch.sum(x[::stride, :].float()).reshape(1, 1)


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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, q_offset: int = 0
) -> torch.Tensor:
    """q (BH, Sq, hd); k/v (BH, Skv, hd)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) * scale
    if causal:
        sq, skv = s.shape[-2], s.shape[-1]
        qi = q_offset + torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)


def ssm_scan_ref(u, a_log, b, c):
    """Sequential SSD recurrence.  u (BH,S,P); a_log (BH,S); b/c (BH,S,N)."""
    bh, s, p = u.shape
    n = b.shape[-1]
    uf, af, bf, cf = u.float(), a_log.float(), b.float(), c.float()
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=u.device)
    ys = []
    for t in range(s):
        h = h * torch.exp(af[:, t])[:, None, None] + uf[:, t, :, None] * bf[:, t, None, :]
        ys.append(torch.einsum("bpn,bn->bp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(u.dtype)
