"""Shared layers/utilities: norms, RoPE, initializers, dtype policy.

Port of ``repro.models.common``.  Parameters are plain dicts of tensors with
the reference's keys and layouts; initializers draw from an explicit
``torch.Generator`` and put the tensors on its device.  They draw from the
reference's distributions, not its numbers: tests that need equal weights
convert the reference's with :func:`repro_torch.models.convert.params_from_jax`.
"""
from __future__ import annotations

import math
from typing import Any

import torch

Params = dict[str, Any]

_TRUNC = 3.0  # truncation of the initializers' normal, in standard deviations


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def truncated_normal(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], drawn by inverse CDF on
    ``gen``'s device (the method of ``jax.random.truncated_normal``)."""
    lo = 0.5 * (1.0 + math.erf(-_TRUNC / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float32, device=gen.device)
    u.uniform_(lo, 1.0 - lo, generator=gen)
    x = u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0)).clamp_(-_TRUNC, _TRUNC)
    return x.to(dtype)


def dense_init(gen, shape, fan_in: int | None = None, dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal init scaled by 1/sqrt(fan_in) (llama-style)."""
    if fan_in is None:
        fan_in = shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return truncated_normal(gen, shape, dtype).mul_(std)


def embed_init(gen, shape, dtype=torch.float32) -> torch.Tensor:
    return truncated_normal(gen, shape, dtype).mul_(0.02)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, dtype=torch.float32, *, stack: tuple = (), device=None) -> Params:
    return {"scale": torch.ones((*stack, d), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in fp32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def token_positions(b: int, s: int, device) -> torch.Tensor:
    """Positions 0..s-1 of a (b, s) batch, int32."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,), float32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).

    Each head is split in halves (``x1, x2``), as in the reference; pairs are
    not interleaved."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions.float()[..., None] * inv  # (..., seq, hd/2)
    sin = torch.sin(ang)[..., None, :]  # (..., seq, 1, hd/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dtype / loss utilities
# ---------------------------------------------------------------------------
def as_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def scalar(value: float, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` rounded to ``dtype`` first, as ``jnp.asarray(value, dtype)``."""
    return torch.tensor(value, dtype=dtype, device=device)


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token cross-entropy in fp32: logsumexp minus the gold logit."""
    logits32 = logits.float()
    m = logits32.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits32 - m).sum(dim=-1)) + m[..., 0]
    gold = torch.gather(logits32, -1, targets[..., None].long())[..., 0]
    return lse - gold


def mask_vocab_pad(logits: torch.Tensor, cfg) -> torch.Tensor:
    """-1e30 over the pad region of padded-vocab logits (no-op when unpadded)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    iota = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(iota < cfg.vocab_size, logits, scalar(-1e30, logits.dtype, logits.device))


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list/tuple, depth first."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, keeping its keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def count_params(params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))
