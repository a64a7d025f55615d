"""Plain float32 layers shared by the references, and the float8 control.

``Numerics(quant=True)`` is the control: every matmul's operands are rounded
to float8 e4m3 with a per-tensor scale before the float32 product, the step
below the bfloat16 compute the configurations state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in float32;
    the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp_min(1e-12)
    scale = amax / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


class Numerics:
    """Float32 everywhere; ``quant``: each matmul's operands in float8."""

    def __init__(self, quant: bool = False):
        self.quant = quant

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        ops = tuple(o.float() for o in ops)
        if self.quant:
            ops = tuple(fake_fp8(o) for o in ops)
        return torch.einsum(eq, *ops)


def fp32_matmuls():
    """A context in which float32 matmuls stay float32 (no TF32)."""
    class _Ctx:
        def __enter__(self):
            self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        def __exit__(self, *exc):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev

    return _Ctx()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (..., S, H, hd) at ``positions`` (..., S): each
    head split in halves (x1, x2), not interleaved."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = positions.float()[..., None] * inv
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(num: Numerics, q, k, v) -> torch.Tensor:
    """Softmax attention, q (B,S,H,hd), k/v (B,S,K,hd), query head h reading
    KV head h // (H // K); each position sees itself and those before."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = num.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return num.einsum("bhqk,bkhd->bqhd", p, v)


def moe_capacity(tokens: int, k: int, capacity_factor: float, n_experts: int) -> int:
    """Slots an expert has in one routing group of ``tokens`` tokens: the
    share ``capacity_factor`` allows, rounded up to a multiple of 8, and at
    least 8."""
    cap = int(tokens * k * capacity_factor / n_experts)
    return max(8, -(-cap // 8) * 8)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")
