"""Steady-state timing harness (the paper's clock-bracket methodology).

On the card each rep is bracketed by a pair of ``torch.cuda.Event``s and
read after a synchronize, so the time is the device's, not the enqueue's.  A
spin kernel runs ahead of each rep: the host enqueues the events and ``fn``'s
launches while the device spins, so the bracket holds device work and not
the host's dispatch (where the host takes longer than the spin, as in an
eager chain of thousands of ops, the gap stays in the reading).  On the CPU
the host clock (``perf_counter``) brackets each call.

:func:`span` and :func:`count` mark the program's own layers (the engine
tick's phases, the MoE's dispatch, the train step's phases) while a
``torch.profiler`` records, and :func:`trace_store` hands them back.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

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


def percentile(samples, q: float) -> float:
    """Linear-interpolated percentile (``q`` in [0, 100]) of a sample
    sequence; NaN on empty input.  Shared by the serving metrics and any
    harness that reports latency distributions."""
    samples = list(samples)
    if not samples:
        return float("nan")
    import numpy as np

    return float(np.percentile(samples, q))


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


# ---------------------------------------------------------------------------
# spans and counters, recorded while a profiler records
# ---------------------------------------------------------------------------
#: whether a ``torch.profiler`` records on this thread (autograd's worker
#: threads inherit the state of the thread that started the backward)
_profiling = torch._C._autograd._profiler_enabled


class _Store:
    """The newest traced stretch: finished spans, counters, and whether a
    span or count found the profiler off since (the next one under a
    profiler then starts a new stretch)."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.stale = True
        self.lock = threading.Lock()
        self.local = threading.local()  # .stack: the thread's open spans
        self.ids = itertools.count()

    def fresh(self) -> None:
        if self.stale:
            with self.lock:
                if self.stale:
                    self.spans, self.counters, self.stale = [], {}, False

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_STORE = _Store()


class _Off:
    """What :func:`span` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "tag", "id", "parent", "rf", "events", "t0")

    def __init__(self, name: str, device, tag):
        self.name, self.device, self.tag = name, device, tag

    def __enter__(self):
        _STORE.fresh()
        stack = _STORE.stack()
        up = stack[-1] if stack else None
        self.id = next(_STORE.ids)
        self.parent = up.id if up is not None else None
        if self.tag is None and up is not None:
            self.tag = up.tag
        self.rf = _RecordFunctionFast("repro_torch." + self.name)
        self.rf.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.rf.__exit__(*exc)
        stack = _STORE.stack()
        if stack and stack[-1] is self:
            stack.pop()
        _STORE.spans.append((self.id, self.name, self.parent, threading.get_ident(), self.t0,
                             t1, self.tag, self.device is not None, self.events))
        return False


def span(name: str, device=None, tag: Optional[int] = None):
    """A context manager that marks ``name`` as one of the program's spans
    while a ``torch.profiler`` records: ``repro_torch.<name>`` in the
    profiler's host timeline (a function event, not a user annotation, so
    nothing of it lands on the device's rows), and a record in the store
    that :func:`trace_store` returns.  ``device``: the ``torch.device`` the
    span's work runs on; on a CUDA device the span also records a timing event on
    the current stream at each end (no synchronise), on any other the host
    times stand in.  ``tag`` (else the enclosing span's): the engine's tick.
    While no profiler records, one shared object that does nothing."""
    if not _profiling():
        _STORE.stale = True
        return _OFF
    return _Span(name, device, tag)


def count(name: str, n) -> None:
    """Adds ``n`` to the counter ``name`` while a profiler records."""
    if not _profiling():
        _STORE.stale = True
        return
    _STORE.fresh()
    with _STORE.lock:
        _STORE.counters[name] = _STORE.counters.get(name, 0) + n


def trace_store() -> dict:
    """The newest traced stretch: ``spans``, each a dict of ``name``,
    ``id``, its ``parent``'s id (None at a thread's outermost), ``thread``,
    ``start_s`` and ``end_s`` (``perf_counter``), ``tag`` and ``device_s``
    (a device span's time on its device, one synchronise resolving them
    all; None for a host span), in the order they started; and
    ``counters``.  The stretch lasts until the first span or count under a
    profiler after one that found none."""
    recs = list(_STORE.spans)
    if any(r[8] is not None for r in recs):
        torch.cuda.synchronize()
    spans = []
    for sid, name, parent, thread, t0, t1, tag, device, events in sorted(recs,
                                                                          key=lambda r: r[4]):
        if events is not None:
            device_s = events[0].elapsed_time(events[1]) / 1e3
        else:
            device_s = (t1 - t0) / 1e9 if device else None
        spans.append({"name": name, "id": sid, "parent": parent, "thread": thread,
                      "start_s": t0 / 1e9, "end_s": t1 / 1e9, "tag": tag,
                      "device_s": device_s})
    with _STORE.lock:
        counters = dict(_STORE.counters)
    return {"spans": spans, "counters": counters}
