"""Straggler detection informed by the paper's throttling model (§4.5).

The paper shows a thermally-throttled T4 settles at a predictable clock
derate (Fig 4.4/4.5).  On a fleet, a chip entering that regime inflates its
step time by ``slowdown_factor`` — a *known* signature.  The detector keeps
an EWMA + median of per-worker step times and flags workers whose inflation
matches or exceeds the throttle signature (or an absolute factor), rather
than using a naive fixed threshold that either misses early throttling or
false-positives on normal jitter.

Mitigations (policy layer): reroute data shards away from flagged workers /
exclude + elastic-reshard (``ElasticController``, ``ft/elastic.py``) — both
driven by these flags.

Port of ``repro.ft.straggler`` (host code, ported whole), over the port's
copy of the throttle model; the defaults stay the reference's (the TPU v5e
throttle signature: the port has no H100 throttle model yet).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from statistics import median
from typing import Optional

from repro_torch.core.throttle import ThrottleParams, V5E_THROTTLE, slowdown_factor


@dataclass
class StragglerDetector:
    throttle: ThrottleParams = V5E_THROTTLE
    utilization: float = 0.9
    ewma_alpha: float = 0.2
    margin: float = 0.5  # flag at (1-margin) of the full throttle signature
    min_samples: int = 5
    _ewma: dict = field(default_factory=dict)
    _history: dict = field(default_factory=dict)
    _signature: Optional[float] = None

    def signature(self) -> float:
        """Step-time inflation of a fully-throttled chip (from the model)."""
        if self._signature is None:
            self._signature = slowdown_factor(self.throttle, self.utilization)
        return self._signature

    def forget(self, worker: str):
        """Drop ``worker``'s samples (failed over / revived): a replica that
        comes back healthy must not be re-flagged on its throttled history."""
        self._ewma.pop(worker, None)
        self._history.pop(worker, None)

    def observe(self, worker: str, step_time_s: float):
        prev = self._ewma.get(worker)
        self._ewma[worker] = (
            step_time_s
            if prev is None
            else self.ewma_alpha * step_time_s + (1 - self.ewma_alpha) * prev
        )
        self._history.setdefault(worker, []).append(step_time_s)

    def fleet_median(self) -> Optional[float]:
        vals = [v for v in self._ewma.values()]
        return median(vals) if vals else None

    def stragglers(self) -> list[tuple[str, float]]:
        """[(worker, inflation)] for workers at/beyond the throttle signature."""
        med = self.fleet_median()
        if med is None or med <= 0:
            return []
        sig = self.signature()
        thresh = 1.0 + (sig - 1.0) * (1.0 - self.margin)
        out = []
        for w, v in self._ewma.items():
            if len(self._history.get(w, ())) < self.min_samples:
                continue
            inflation = v / med
            if inflation >= thresh:
                out.append((w, inflation))
        return sorted(out, key=lambda t: -t[1])

    def likely_thermal(self, worker: str) -> bool:
        """Inflation consistent with the thermal-throttle signature
        specifically (vs. e.g. network slowness, which inflates further)."""
        med = self.fleet_median()
        if med is None or worker not in self._ewma:
            return False
        inflation = self._ewma[worker] / med
        sig = self.signature()
        return 0.8 * sig <= inflation <= 1.3 * sig
