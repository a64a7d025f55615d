"""Streaming sessions: the handle ``ServeEngine.submit`` returns.

Port of ``repro.serve.session``: host code, ported whole.

A :class:`Session` carries the request, its incremental output (with an
optional per-token callback), cancellation, and per-request timing stats
(TTFT, inter-token latencies) that :mod:`repro_torch.serve.metrics` aggregates.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

# session lifecycle: QUEUED -> PREFILL -> ACTIVE -> DONE | CANCELLED
# (a paged engine may preempt an ACTIVE session back to QUEUED; it re-enters
# PREFILL with its prior output intact and resumes exactly — see
# ServeEngine._preempt)
QUEUED = "queued"
PREFILL = "prefill"
ACTIVE = "active"
DONE = "done"
CANCELLED = "cancelled"

# finish reasons
FINISH_EOS = "eos"
FINISH_MAX_NEW_TOKENS = "max_new_tokens"
FINISH_MAX_LEN = "max_len"
FINISH_CANCELLED = "cancelled"
FINISH_DEADLINE = "deadline"  # per-request deadline expired before completion


@dataclass
class RequestStats:
    """Wall-clock trace of one request's life (absolute perf_counter stamps)."""

    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    token_times: list = field(default_factory=list)
    preemptions: int = 0  # times evicted (paged pool pressure) and resumed
    # times the engine put the session back in the queue after it had been
    # drained / preempted / quarantined — the retry-budget denominator
    # (pool-misfit waits in paged admission do NOT count; see
    # ServeEngine.requeue)
    requeues: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit -> first generated token (includes queueing + prefill)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def token_latencies_s(self) -> list:
        """Inter-token gaps after the first token (decode-tick latencies)."""
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    @property
    def total_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at


@dataclass
class Session:
    """One request in flight.  Engine-owned fields; callers read ``out``,
    ``status``, ``finish_reason`` and may call :meth:`cancel` at any time."""

    rid: int
    prompt: list  # token ids
    max_new_tokens: int
    priority: int = 0  # higher admits first under PriorityScheduler
    on_token: Optional[Callable] = None  # fn(session, token) per generated token
    # wall-clock budget from submit; when it runs out the engine finishes the
    # session with finish_reason="deadline" and partial output (None: no limit)
    deadline_s: Optional[float] = None
    status: str = QUEUED
    out: list = field(default_factory=list)
    finish_reason: str = ""
    stats: RequestStats = field(default_factory=RequestStats)
    _cancel_requested: bool = field(default=False, repr=False)
    # set by the engine at submit so queued-cancels still reach its
    # metrics/finished accounting (running cancels go through the step loop)
    _on_queued_cancel: Optional[Callable] = field(default=None, repr=False)
    # engine tick before which a requeued session must not be re-admitted
    # (exponential backoff; see ServeEngine.requeue)
    _backoff_until: int = field(default=0, repr=False)

    def deadline_expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_s is None:
            return False
        now = time.perf_counter() if now is None else now
        return now - self.stats.submitted_at > self.deadline_s

    @property
    def done(self) -> bool:
        return self.status in (DONE, CANCELLED)

    @property
    def cancel_requested(self) -> bool:
        return self._cancel_requested

    def cancel(self) -> None:
        """Request cancellation.  Queued sessions are dropped immediately;
        running sessions are released at the next engine step boundary."""
        if self.done:
            return
        self._cancel_requested = True
        if self.status == QUEUED:
            self._finish(FINISH_CANCELLED)
            if self._on_queued_cancel is not None:
                self._on_queued_cancel(self)

    # -- engine-side transitions -------------------------------------------
    def _record_token(self, token: int, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        self.out.append(int(token))
        self.stats.token_times.append(now)
        if self.stats.first_token_at is None:
            self.stats.first_token_at = now
        if self.on_token is not None:
            self.on_token(self, int(token))

    def _finish(self, reason: str, now: Optional[float] = None) -> None:
        self.status = CANCELLED if reason == FINISH_CANCELLED else DONE
        self.finish_reason = reason
        self.stats.finished_at = time.perf_counter() if now is None else now
