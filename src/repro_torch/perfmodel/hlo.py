"""Collective traffic of a program, as the roofline's collective term reads it.

Of ``repro.perfmodel.hlo`` only the :class:`CollectiveStats` record is
ported: the reference fills it by parsing XLA's HLO text, which a PyTorch
program does not have.  A program on one card moves no collective bytes, so
``CollectiveStats()`` is its record.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class CollectiveStats:
    per_device_bytes: float = 0.0  # link traffic per device (ring model)
    payload_bytes: float = 0.0  # raw result bytes (no algorithm factor)
    op_counts: dict = field(default_factory=lambda: defaultdict(int))
    op_bytes: dict = field(default_factory=lambda: defaultdict(float))

    def summary(self) -> dict:
        return {
            "per_device_bytes": self.per_device_bytes,
            "payload_bytes": self.payload_bytes,
            "op_counts": dict(self.op_counts),
            "op_bytes": {k: float(v) for k, v in self.op_bytes.items()},
        }
