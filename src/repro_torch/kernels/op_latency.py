"""Dependent-chain ALU latency kernels (the paper's Tab 4.1), one instance per
row of ``core.probes._OP_TABLE`` plus a move-only baseline.

The kernel (``csrc/op_latency.cu``) stands in for the reference's jitted
``fori_loop`` chain in ``repro/core/probes.py::probe_op_latency`` (no
``pallas_call``).  Each of ``width`` lanes of one block runs ``chain``
dependent steps of one op in a register and writes the result;
:func:`op_chain` launches it, and the probe times one launch per op with CUDA
events and subtracts the move-only chain.  :data:`CHAINS` are the same chains
as PyTorch ops: the plain version, on any device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _util

# name: (kind, c0, c1, i0): the constants of core.probes._OP_TABLE, in the
# order of the Op enum of csrc/op_latency.cu
OPS = {
    "move": ("f32", 0.0, 0.0, 0),
    "add.f32": ("f32", 1.000001, 0.0, 0),
    "mul.f32": ("f32", 1.000001, 0.0, 0),
    "fma.f32": ("f32", 1.000001, 1e-7, 0),
    "max.f32": ("f32", 0.5, 0.0, 0),
    "rsqrt.f32": ("f32", 1.0, 0.0, 0),
    "exp.f32": ("f32", 1e-8, 0.0, 0),
    "tanh.f32": ("f32", 0.999, 0.0, 0),
    "log.f32": ("f32", 1.0, 0.0, 0),
    "add.s32": ("s32", 0.0, 0.0, 1),
    "mul.s32": ("s32", 0.0, 0.0, 1),
    "shift.s32": ("s32", 0.0, 0.0, 1),
}
_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_int,
)


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def _fma(x: torch.Tensor, c: float, d: float) -> torch.Tensor:
    # one rounding, as fma.rn.f32: x * c is exact in float64 and, for the
    # chain's x in [0.5, 2), so is adding d, so the cast rounds once
    return (x.double() * _f32(c) + _f32(d)).float()


#: each op's step as PyTorch ops, on the constants of OPS; fma rounds once
#: (the kernel's fma.rn.f32), where _OP_TABLE's eager ``x * c + d`` rounds twice
CHAINS = {
    "move": lambda x: x,
    "add.f32": lambda x: x + 1.000001,
    "mul.f32": lambda x: x * 1.000001,
    "fma.f32": lambda x: _fma(x, 1.000001, 1e-7),
    "max.f32": lambda x: torch.clamp_min(x, 0.5),
    "rsqrt.f32": lambda x: torch.rsqrt(torch.abs(x) + 1.0),
    "exp.f32": lambda x: torch.exp(x * 1e-8),
    "tanh.f32": lambda x: torch.tanh(x * 0.999),
    "log.f32": lambda x: torch.log(torch.abs(x) + 1.0),
    "add.s32": lambda x: x + 1,
    "mul.s32": lambda x: x * 1,
    "shift.s32": lambda x: (x << 1) >> 1,
}


def chain_input(kind: str, width: int, device) -> torch.Tensor:
    """The probe's starting values: ``arange`` for s32, ``linspace(0.5, 1.5)``
    for f32, as the reference's."""
    if kind == "s32":
        return torch.arange(width, dtype=torch.int32, device=device)
    return torch.linspace(0.5, 1.5, width, dtype=torch.float32, device=device)


def op_chain_ref(name: str, x0: torch.Tensor, chain: int) -> torch.Tensor:
    """``chain`` steps of op ``name`` as PyTorch ops: the plain version."""
    x = x0
    for _ in range(chain):
        x = CHAINS[name](x)
    return x


def op_chain(name: str, x0: torch.Tensor, chain: int) -> torch.Tensor:
    """``chain`` dependent steps of op ``name`` from ``x0`` (one value a lane,
    int32 for the s32 ops, float32 for the rest, at most 1024 lanes).  On
    CUDA tensors this launches the kernel; CPU tensors take the plain
    version."""
    kind, c0, c1, i0 = OPS[name]
    want = torch.int32 if kind == "s32" else torch.float32
    if x0.dtype != want or x0.ndim != 1:
        raise TypeError(f"op {name} chains a 1-D {want} tensor, got {x0.dtype} {tuple(x0.shape)}")
    if x0.device.type == "cpu":
        return op_chain_ref(name, x0, chain)
    if not 1 <= x0.numel() <= 1024:
        raise ValueError(f"one block takes 1 to 1024 lanes, got {x0.numel()}")
    x0 = x0.contiguous()
    out = torch.empty_like(x0)
    _util.launch("op_latency", "repro_op_latency", _ARGTYPES, x0.device, list(OPS).index(name),
                 x0.data_ptr(), out.data_ptr(), x0.numel(), chain, c0, c1, i0)
    return out
