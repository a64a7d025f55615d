"""Gradient compression for slow (cross-pod) links.

Port of ``repro.dist.compress``.  int8 symmetric quantization with a
per-tensor scale; ``psum_compressed`` is an all-reduce that ships int8
payloads + one fp32 scale per rank (all-gather quantized, reduce locally:
the sum of the dequantized terms, so the result is exact up to per-sender
rounding).  Error feedback is left to the caller: quantize ``g + err`` and
carry ``err = (g + err) - dequant``.
"""
from __future__ import annotations

import torch

from . import collectives
from .sharding import current_mesh


def quantize_int8(x: torch.Tensor) -> tuple:
    """Symmetric per-tensor int8: returns (q, scale) with x ~= q * scale.
    Bit for bit the reference's: ``torch.round`` rounds half to even, as
    ``jnp.round`` does, and a 16-bit ``x`` is divided in fp32, as JAX
    promotes it against the fp32 scale."""
    s = x.abs().max().float() / 127.0
    s = torch.clamp_min(s, 1e-30)  # zero tensors stay zero
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q, s


def dequantize_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def psum_compressed(x: torch.Tensor, axis_name: str, mode: str = "int8", *,
                    mesh=None) -> torch.Tensor:
    """All-reduce over the ``axis_name`` ranks of ``mesh`` (default: the
    current mesh) with a compressed payload: the ranks' dequantized terms
    summed in rank order.  ``mode="none"`` is an exact all-reduce."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise RuntimeError("psum_compressed needs a bound mesh (pass mesh= or enter "
                           "activation_sharding(mesh))")
    if mode in (None, "none"):
        return collectives.all_reduce(x, mesh, axis_name)
    if mode != "int8":
        raise ValueError(f"unknown compression mode {mode!r}")
    q, s = quantize_int8(x)
    qg = collectives.all_gather(q[None], mesh, axis_name)  # (N, *x.shape) int8
    sg = collectives.all_gather(s.reshape(1), mesh, axis_name)  # (N,) f32
    out = dequantize_int8(qg[0], sg[0])
    for i in range(1, qg.shape[0]):
        out = out + dequantize_int8(qg[i], sg[i])
    return out.to(x.dtype)
