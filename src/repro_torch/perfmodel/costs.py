"""Per-device FLOPs and bytes of a PyTorch callable, counted as it runs.

Port of ``repro.perfmodel.costs``.  The reference reads them off a compiled
XLA executable (``cost_analysis()`` and ``memory_analysis()``); PyTorch runs
eagerly, so :func:`extract_costs` runs the callable once under two dispatch
modes and counts what reaches ATen:

* FLOPs from :class:`torch.utils.flop_counter.FlopCounterMode` (matmuls,
  convolutions, attention; elementwise ops count none, where XLA counts one
  an element);
* bytes as each ATen op's tensor inputs read once and outputs written once
  (views move nothing and count nothing).  XLA counts a fused elementwise
  chain once; here every op of the chain counts, so the bytes of an unfused
  eager program run above XLA's;
* transcendentals as the output elements of the transcendental ops.

A hand kernel called through ``ctypes`` is not an ATen op, so the counter
does not see it: count a model on its plain path (``attn_impl="blockwise"``,
``ssm_impl="xla"``), which computes the same function.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


@dataclass
class CompiledCosts:
    flops_per_device: float
    bytes_per_device: float
    transcendentals: float
    # memory analysis (per device)
    arg_bytes: int
    out_bytes: int
    temp_bytes: int
    alias_bytes: int
    code_bytes: int

    @property
    def peak_hbm_bytes(self) -> int:
        """Live-at-once estimate: args + outputs + temps - aliased."""
        return self.arg_bytes + self.out_bytes + self.temp_bytes - self.alias_bytes

    def summary(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "transcendentals": self.transcendentals,
            "arg_bytes": self.arg_bytes,
            "out_bytes": self.out_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "peak_hbm_bytes": self.peak_hbm_bytes,
        }


_aten = torch.ops.aten
TRANSCENDENTAL_OPS = frozenset({
    _aten.exp, _aten.exp2, _aten.expm1, _aten.log, _aten.log1p, _aten.log2, _aten.rsqrt,
    _aten.sqrt, _aten.tanh, _aten.sigmoid, _aten.sin, _aten.cos, _aten.erf, _aten.pow,
    _aten.silu, _aten.gelu, _aten.softplus, _aten._softmax, _aten._log_softmax,
})


def _tensor_bytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(obj)
               if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Each non-view ATen op's input and output tensor bytes, and the output
    elements of the transcendental ops."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
            if func.overloadpacket in TRANSCENDENTAL_OPS:
                self.transcendentals += sum(t.numel() for t in tree_leaves(out)
                                            if isinstance(t, torch.Tensor))
        return out


def extract_costs(fn, *args, **kwargs) -> CompiledCosts:
    """Run ``fn(*args, **kwargs)`` once and count its FLOPs and bytes.

    ``arg_bytes`` / ``out_bytes`` are the tensor bytes of the arguments and
    of the result.  ``temp_bytes`` is the card's allocation peak during the
    call above what was allocated before it, less the result's bytes, and 0
    on the CPU, where it is not measured; nothing is aliased or compiled, so
    ``alias_bytes`` and ``code_bytes`` are 0.
    """
    devs = {t.device for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)}
    cuda = next((d for d in devs if d.type == "cuda"), None)
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        before = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
    counter = _ByteCounter()
    with FlopCounterMode(display=False) as flops, counter:
        out = fn(*args, **kwargs)
    out_bytes = _tensor_bytes(out)
    temp = 0
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        temp = max(torch.cuda.max_memory_allocated(cuda) - before - out_bytes, 0)
    return CompiledCosts(
        flops_per_device=float(flops.get_total_flops()),
        bytes_per_device=float(counter.bytes),
        transcendentals=float(counter.transcendentals),
        arg_bytes=_tensor_bytes((args, kwargs)),
        out_bytes=out_bytes,
        temp_bytes=int(temp),
        alias_bytes=0,
        code_bytes=0,
    )
