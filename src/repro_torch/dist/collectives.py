"""The collectives the distribution layer places where the reference's
sharding rules imply them, over one axis of a bound
:class:`~repro_torch.launch.mesh.Mesh`.

Each returns a new tensor and leaves its input as it was.  Over NCCL they
take the tensor where it lies.  Over gloo (ranks sharing one GPU, or on the
CPU) a CUDA tensor is staged through host memory, the only path every gloo
version takes, and data that only moves goes as its bytes (gloo versions
differ in the dtypes they take: torch 2.11's gloo refuses int16).  Sums of
16-bit floats are taken in fp32 (one rounding, as a single device's
fp32-accumulated sum rounds once).

Under :func:`recording` every call of the six is recorded as a
:class:`CollectiveCall`; a dry recording (the default) sends nothing and
returns a ``meta`` tensor of the shape and dtype the call returns, so one
rank's program runs on a mesh placed without a world (``Mesh.place``).
Only the calls the program makes are recorded: gloo's reduce-scatter, an
all-reduce and a slice inside, is recorded once, as a reduce-scatter.
"""
from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class CollectiveCall(NamedTuple):
    """One recorded call: ``payload_bytes`` are the input's bytes,
    ``wire_bytes`` those of the operand the NCCL path reduces or moves (a
    16-bit float sum goes in fp32)."""

    op: str
    axis: str
    n: int
    payload_bytes: int
    wire_bytes: int


class Recorder:
    """The calls made under :func:`recording`, in order."""

    def __init__(self, dry: bool):
        self.dry = dry
        self.calls: list = []

    def by_op(self) -> dict:
        return by_op(self.calls)


def by_op(calls) -> dict:
    """{op: {"calls": n, "bytes": payload bytes}} of recorded calls."""
    out: dict = {}
    for c in calls:
        s = out.setdefault(c.op, {"calls": 0, "bytes": 0})
        s["calls"] += 1
        s["bytes"] += c.payload_bytes
    return out


_recorder: Optional[Recorder] = None


@contextmanager
def recording(dry: bool = True):
    """Record every collective the program calls.  ``dry``: send nothing and
    return ``meta`` results (the mesh needs no process group); else the
    calls run as they would and are recorded too."""
    global _recorder
    prev, rec = _recorder, Recorder(dry)
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = prev


def _sums(x: torch.Tensor) -> torch.dtype:
    """The dtype a sum of ``x`` over ranks is taken in."""
    return torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype


def _meta(shape, x: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=x.dtype, device="meta")


def _resized(x: torch.Tensor, dim: int, size: int) -> list:
    shape = list(x.shape)
    shape[dim] = size
    return shape


def _recorded(summed: bool, meta_result):
    """Record a call under :func:`recording`; a dry one returns
    ``meta_result(x, mesh, axis, *args)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(x, mesh, axis, *args, **kw):
            rec = _recorder
            if rec is None:
                return fn(x, mesh, axis, *args, **kw)
            payload = x.numel() * x.element_size()
            wire = x.numel() * _sums(x).itemsize if summed else payload
            rec.calls.append(CollectiveCall(fn.__name__, axis, axis_size(mesh, axis), payload,
                                            wire))
            if rec.dry:
                return meta_result(x, mesh, axis, *args, **kw)
            return fn(x, mesh, axis, *args, **kw)

        return run

    return wrap


def _gloo_host(x: torch.Tensor, group) -> bool:
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as a collective that moves it takes it: over gloo its bytes on
    the host; :func:`_unwire` turns them back."""
    if dist.get_backend(group) != "gloo":
        return x.contiguous()
    return x.to("cpu").contiguous().reshape(-1).view(torch.uint8)


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.view(like.dtype).reshape(like.shape).to(like.device)


def axis_size(mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


@_recorded(True, lambda x, mesh, axis: _meta(x.shape, x))
def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ``axis`` ranks, in ``x``'s dtype."""
    group = mesh.group(axis)
    y = x.to("cpu" if _gloo_host(x, group) else x.device, _sums(x), copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.device, x.dtype)


@_recorded(False, lambda x, mesh, axis, dim=0: _meta(
    _resized(x, dim, x.shape[dim] * axis_size(mesh, axis)), x))
def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ``axis`` ranks' ``x`` concatenated along ``dim``, in rank order."""
    group = mesh.group(axis)
    bits = _wire(x, group)
    parts = [torch.empty_like(bits) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, bits, group=group)
    return torch.cat([_unwire(p, x) for p in parts], dim=dim)


@_recorded(True, lambda x, mesh, axis, dim=0: _meta(
    _resized(x, dim, x.shape[dim] // axis_size(mesh, axis)), x))
def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's ``dim`` slice (its ``axis`` index of ``n`` equal ones) of
    the sum of ``x`` over the ``axis`` ranks, in ``x``'s dtype.  NCCL
    reduce-scatters; over gloo the staged host copy is all-reduced and
    sliced, faster on a host than gloo's own ``reduce_scatter_tensor``
    (``python tools/gloo_ab.py dist`` times both)."""
    group = mesh.group(axis)
    n, i = axis_size(mesh, axis), mesh.index(axis)
    if dist.get_backend(group) == "gloo":
        y = x.to("cpu" if _gloo_host(x, group) else x.device, _sums(x), copy=True)
        dist.all_reduce(y, group=group)
        k = x.shape[dim] // n
        return y.narrow(dim, i * k, k).to(x.device, x.dtype).contiguous()
    xm = x.movedim(dim, 0).to(_sums(x)).contiguous()
    out = torch.empty((xm.shape[0] // n, *xm.shape[1:]), dtype=xm.dtype, device=xm.device)
    dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim).to(x.dtype).contiguous()


@_recorded(False, lambda x, mesh, axis, src: _meta(x.shape, x))
def broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """The ``x`` of the rank at index ``src`` of the ``axis`` line, on every
    rank of it; the other ranks' ``x`` gives only the shape and dtype."""
    group = mesh.group(axis)
    bits = _wire(x, group)
    if mesh.index(axis) != src:
        bits = torch.empty_like(bits)
    elif not _gloo_host(x, group):  # _wire gave x's own storage
        bits = bits.clone()
    dist.broadcast(bits, mesh.axis_ranks(axis)[src], group=group)
    return _unwire(bits, x)


@_recorded(True, lambda x, mesh, axis, dst: (_meta(x.shape, x) if mesh.index(axis) == dst
                                             else None))
def reduce(x: torch.Tensor, mesh, axis: str, dst: int):
    """Sum of ``x`` over the ``axis`` ranks, in ``x``'s dtype, on the rank
    at index ``dst`` of the line; None on the others."""
    group = mesh.group(axis)
    y = x.to("cpu" if _gloo_host(x, group) else x.device, _sums(x), copy=True)
    dist.reduce(y, mesh.axis_ranks(axis)[dst], group=group)
    return y.to(x.device, x.dtype) if mesh.index(axis) == dst else None


@_recorded(False, lambda x, mesh, axis, step=1: _meta(x.shape, x))
def shift(x: torch.Tensor, mesh, axis: str, step: int = 1) -> torch.Tensor:
    """``x`` sent ``step`` places along the ``axis`` ring; returns what the
    rank ``step`` places back sent (``jax.lax.ppermute`` over the ring)."""
    ranks, i = mesh.axis_ranks(axis), mesh.index(axis)
    n = len(ranks)
    if n == 1:
        return x.clone()
    group = mesh.group(axis)
    bits = _wire(x, group)
    out = torch.empty_like(bits)
    send = dist.isend(bits, ranks[(i + step) % n], group=group)
    dist.recv(out, ranks[(i - step) % n], group=group)
    send.wait()
    return _unwire(out, x)
