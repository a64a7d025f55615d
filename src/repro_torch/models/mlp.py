"""MLP variants (swiglu / geglu / gelu).

Port of ``repro.models.mlp``'s dense half.  The MoE block (``moe_init``,
``moe_block``, ``moe_block_dense``) is queued in ROADMAP.md and raises here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Params, dense_init


def mlp_init(gen, cfg, d_in: int | None = None, dtype=torch.float32, *,
             stack: tuple = ()) -> Params:
    """MLP weights on ``gen``'s device; ``stack`` prepends a leading shape."""
    d = d_in if d_in is not None else cfg.d_model
    f = cfg.d_ff
    if cfg.mlp_variant in ("swiglu", "geglu"):
        return {
            "wi_gate": dense_init(gen, (*stack, d, f), fan_in=d, dtype=dtype),
            "wi_up": dense_init(gen, (*stack, d, f), fan_in=d, dtype=dtype),
            "wo": dense_init(gen, (*stack, f, cfg.d_model), fan_in=f, dtype=dtype),
        }
    return {
        "wi": dense_init(gen, (*stack, d, f), fan_in=d, dtype=dtype),
        "wo": dense_init(gen, (*stack, f, cfg.d_model), fan_in=f, dtype=dtype),
    }


def _act(cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_variant == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu(approximate=True)


def mlp(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = x.dtype
    if "wi_gate" in params:
        g = _act(cfg, x @ params["wi_gate"].to(dt))
        u = x @ params["wi_up"].to(dt)
        return (g * u) @ params["wo"].to(dt)
    h = _act(cfg, x @ params["wi"].to(dt))
    return h @ params["wo"].to(dt)


def _moe_queued(*_args, **_kwargs):
    raise NotImplementedError(
        "the MoE block is not ported yet (queued in ROADMAP.md §1, item 5)"
    )


moe_init = moe_capacity = moe_block = moe_block_dense = _moe_queued
