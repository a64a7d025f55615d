"""Heartbeat monitoring: detects dead/hung workers from missing step beats.

Port of ``repro.ft.heartbeat`` (host code, ported whole).

In a real deployment each host POSTs beats to the coordinator; here the
monitor is the coordinator-side logic, driven by ``beat()`` calls and a
monotonic clock injectable for tests.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class HeartbeatMonitor:
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic
    _last: dict = field(default_factory=dict)  # worker -> (step, t)

    def beat(self, worker: str, step: int):
        self._last[worker] = (step, self.clock())

    def forget(self, worker: str):
        """Stop tracking ``worker`` (it was failed over or decommissioned) —
        otherwise its stale beat keeps it in ``dead_workers()`` forever."""
        self._last.pop(worker, None)

    def dead_workers(self) -> list[str]:
        now = self.clock()
        return sorted(
            w for w, (_, t) in self._last.items() if now - t > self.timeout_s
        )

    def alive_workers(self) -> list[str]:
        now = self.clock()
        return sorted(
            w for w, (_, t) in self._last.items() if now - t <= self.timeout_s
        )

    def min_step(self) -> Optional[int]:
        if not self._last:
            return None
        return min(s for s, _ in self._last.values())
