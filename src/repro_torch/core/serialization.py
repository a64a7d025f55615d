"""Shared serialization primitives for benchmark results and dissect reports.

Lives in ``repro_torch.core`` so that core modules (dissect) and the
higher-level ``repro_torch.bench`` package share one schema version, env
fingerprint, and probe layout; ``repro_torch.bench.schema`` re-exports
everything here.  The record layout is schema v1, the same as ``repro``'s.
"""
from __future__ import annotations

import platform
import sys
from dataclasses import dataclass
from typing import Optional

import torch

from .timing import resolve_device

SCHEMA_VERSION = 1


@dataclass(frozen=True)
class EnvFingerprint:
    """Where a result came from — stored with results and reports."""

    torch_version: str
    cuda_version: str  # the CUDA runtime torch was built with; "" for a CPU build
    backend: str  # "cuda" | "cpu": the device the measurements ran on
    device_kind: str  # torch.cuda.get_device_name, or the host's CPU
    device_count: int
    platform: str
    python_version: str

    @staticmethod
    def capture(device="cuda") -> "EnvFingerprint":
        dev = resolve_device(device)
        if dev.type == "cuda":
            kind, count = torch.cuda.get_device_name(dev), torch.cuda.device_count()
        else:
            kind, count = platform.processor() or platform.machine(), 1
        return EnvFingerprint(
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda or "",
            backend=dev.type,
            device_kind=kind,
            device_count=count,
            platform=platform.platform(),
            python_version=sys.version.split()[0],
        )


def probe_to_dict(res) -> dict:
    """Serialize a core.probes.ProbeResult into the shared probe layout."""
    return {"x": list(res.x), "y": list(res.y), "unit": res.unit, "meta": dict(res.meta)}



def finite(v: float, fallback: Optional[float] = 0.0) -> float:
    """JSON-safe float (strict JSON has no Infinity/NaN)."""
    v = float(v)
    if v != v or v in (float("inf"), float("-inf")):
        return float(fallback)
    return v
