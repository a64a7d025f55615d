"""Legacy adapters for the pre-registry ``benchmarks/`` CSV interface.

Port of ``repro.bench.compat``.  The old harness passed around
``{"name", "us_per_call", "derived"}`` dicts; :func:`legacy_rows` runs a
registered benchmark of the port into that shape.
"""
from __future__ import annotations

from .runner import load_suites
from .schema import BenchRecord


def legacy_row(r: BenchRecord) -> dict:
    us = r.metrics.get("us_per_call")
    if us is None:
        if r.unit in ("us", "us/call"):
            us = r.value
        elif r.unit in ("ns", "ns/load", "ns/op"):
            us = r.value * 1e-3
        elif r.unit == "s":
            us = r.value * 1e6
        else:
            us = 0.0
    derived = r.info or f"{r.value:.2f} {r.unit}"
    return {"name": r.name, "us_per_call": float(us), "derived": derived}


def legacy_rows(benchmark: str, quick: bool = True, **overrides) -> list:
    """Run a registered benchmark; return old-style CSV row dicts.  The
    benchmark measures on the card unless ``device="cpu"`` is among the
    ``overrides``."""
    from repro_torch.core import registry

    load_suites()
    spec = registry.get(benchmark)
    return [
        legacy_row(r) for r in spec.run("quick" if quick else "full", overrides or None)
    ]
