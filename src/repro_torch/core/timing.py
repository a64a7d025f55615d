"""Steady-state timing harness (the paper's clock-bracket methodology).

On the card each rep is bracketed by a pair of ``torch.cuda.Event``s and
read after a synchronize, so the time is the device's, not the enqueue's.  A
spin kernel runs ahead of each rep: the host enqueues the events and ``fn``'s
launches while the device spins, so the bracket holds device work and not
the host's dispatch (where the host takes longer than the spin, as in an
eager chain of thousands of ops, the gap stays in the reading).  On the CPU
the host clock (``perf_counter``) brackets each call.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

#: device cycles the spin kernel runs ahead of each rep: ~1 ms at 1.98 GHz,
#: longer than the host takes to enqueue one call of any probe's kernel
SPIN_CYCLES = 1 << 21


class NoCudaDeviceError(RuntimeError):
    """A CUDA device was asked for (the default) and none is visible."""


@dataclass(frozen=True)
class Timing:
    median_s: float
    min_s: float
    mean_s: float
    reps: int

    @property
    def median_us(self) -> float:
        return self.median_s * 1e6


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raise :class:`NoCudaDeviceError`
    rather than fall back to the CPU when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device is visible; pass device='cpu' to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


def _summary(samples: list) -> Timing:
    samples.sort()
    n = len(samples)
    med = samples[n // 2] if n % 2 else 0.5 * (samples[n // 2 - 1] + samples[n // 2])
    return Timing(median_s=med, min_s=samples[0], mean_s=sum(samples) / n, reps=n)


def time_fn(fn: Callable, *args, warmup: int = 3, reps: int = 10,
            device: Optional[str] = None, **kw) -> Timing:
    """Times ``fn(*args, **kw)``.

    ``device`` picks the clock; by default it is ``cuda`` if any tensor
    argument lies on the card, else ``cpu``.  The CPU clock cannot see device
    work, so it raises on a CUDA tensor among the arguments or the results.
    """
    if device is None:
        on_card = any(t.is_cuda for t in _tensors(args))
        dev = resolve_device("cuda" if on_card else "cpu")
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        return _time_cuda(dev, fn, args, kw, warmup, reps)

    def check(objs, what):
        if any(t.is_cuda for t in _tensors(objs)):
            raise ValueError(f"time_fn on the cpu clock got a CUDA tensor among the {what}")

    check(args, "arguments")
    for _ in range(warmup):
        check(fn(*args, **kw), "results")
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        samples.append(time.perf_counter() - t0)
        check(out, "results")
    return _summary(samples)


def _time_cuda(dev, fn, args, kw, warmup, reps) -> Timing:
    with torch.cuda.device(dev):
        for _ in range(warmup):
            fn(*args, **kw)
        torch.cuda.synchronize(dev)
        samples = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn(*args, **kw)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
    return _summary(samples)
