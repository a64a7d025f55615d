"""Admission scheduling behind a small protocol.

Port of ``repro.serve.scheduler``: host code, ported whole.

The engine owns the slots and the model steps; a :class:`Scheduler` owns
only the *order* in which queued sessions claim free slots.  Any object with
``submit`` / ``select`` / ``pending`` plugs in — the stock policies:

- :class:`FCFSScheduler`        arrival order, admit the moment a slot frees
  (continuous batching at step granularity — the default),
- :class:`PriorityScheduler`    highest ``Session.priority`` first (FIFO
  within a priority class), still continuous,
- :class:`StaticBatchScheduler` admit only into an idle engine (classic
  static batching — the measured contrast to continuous admission).

A paged engine also *re-submits* sessions through ``submit``: a selected
session that does not currently fit in the page pool goes back in the queue,
and a preempted session re-enters with its partial output attached.  Stock
policies treat a re-submission like a fresh arrival (appended / re-heaped);
custom schedulers that care about fairness can inspect
``session.stats.preemptions`` or ``session.out`` to prioritise resumes.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Protocol, runtime_checkable

from .session import Session


@runtime_checkable
class Scheduler(Protocol):
    """Admission policy: queue sessions, pick which claim free slots."""

    def submit(self, session: Session) -> None:
        """Enqueue a new session."""
        ...

    def select(self, n_free: int, n_slots: int) -> list:
        """Up to ``n_free`` sessions to admit now (``n_slots`` is the engine's
        total slot count, for policies that act on batch boundaries).  Must
        never return cancelled/done sessions."""
        ...

    def pending(self) -> int:
        """Number of live queued sessions."""
        ...

    # Optional extension (not part of the minimal protocol): ``drain() ->
    # list[Session]`` returns every live queued session and empties the
    # queue.  ``ServeEngine.drain`` — the cluster's replica-failure path —
    # uses it when present and otherwise falls back to pulling the queue
    # through ``select``, so custom schedulers only need it if their
    # ``select`` withholds sessions (e.g. batch-boundary policies).


class FCFSScheduler:
    """First-come-first-served continuous batching."""

    def __init__(self):
        self._queue: deque = deque()

    def submit(self, session: Session) -> None:
        self._queue.append(session)

    def drain(self) -> list:
        out = [s for s in self._queue if not s.done]
        self._queue.clear()
        return out

    def _prune(self) -> None:
        while self._queue and self._queue[0].done:
            self._queue.popleft()

    def select(self, n_free: int, n_slots: int) -> list:
        out = []
        self._prune()
        while self._queue and len(out) < n_free:
            out.append(self._queue.popleft())
            self._prune()
        return out

    def pending(self) -> int:
        return sum(1 for s in self._queue if not s.done)


class PriorityScheduler:
    """Highest ``Session.priority`` first; FIFO within a priority class."""

    def __init__(self):
        self._heap: list = []
        self._seq = 0

    def submit(self, session: Session) -> None:
        heapq.heappush(self._heap, (-session.priority, self._seq, session))
        self._seq += 1

    def drain(self) -> list:
        out = [s for _, _, s in sorted(self._heap) if not s.done]
        self._heap.clear()
        return out

    def select(self, n_free: int, n_slots: int) -> list:
        out = []
        while self._heap and len(out) < n_free:
            _, _, s = heapq.heappop(self._heap)
            if not s.done:
                out.append(s)
        return out

    def pending(self) -> int:
        return sum(1 for _, _, s in self._heap if not s.done)


class StaticBatchScheduler(FCFSScheduler):
    """Admit only when the engine is fully idle: requests are served in
    drained batches (the non-continuous baseline the bench suite contrasts
    against)."""

    def select(self, n_free: int, n_slots: int) -> list:
        if n_free < n_slots:
            return []
        return super().select(n_free, n_slots)


SCHEDULERS = {
    "fcfs": FCFSScheduler,
    "priority": PriorityScheduler,
    "static": StaticBatchScheduler,
}


def make_scheduler(name: str) -> Scheduler:
    try:
        return SCHEDULERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; registered: {sorted(SCHEDULERS)}"
        ) from None
