"""Benchmark runner: execute registered benchmarks, collect a BenchResult.

Importing :mod:`repro_torch.bench.suites` (done lazily here) registers every
ported paper-table benchmark; the runner then executes the requested subset
with the grid for the requested mode on the requested device and assembles
one schema-versioned result.  A benchmark that raises is recorded in
``result.errors`` and does not abort the rest of the run.
"""
from __future__ import annotations

import inspect
import time
import traceback
from typing import Optional, Sequence

from repro_torch.core import registry
from repro_torch.core.timing import resolve_device

from .schema import BenchResult, EnvFingerprint


def load_suites() -> None:
    """Import the suite package (idempotent registration side effect)."""
    from . import suites  # noqa: F401


def select(only: Optional[Sequence[str]] = None) -> list:
    """Registered benchmark names, optionally filtered by prefix list."""
    load_suites()
    names = registry.names()
    if only:
        names = [n for n in names if any(n.startswith(p) for p in only)]
    return names


def run_benchmarks(
    only: Optional[Sequence[str]] = None,
    mode: str = "quick",
    out_path: Optional[str] = None,
    verbose: bool = False,
    device: str = "cuda",
) -> BenchResult:
    """Run the selected benchmarks on ``device`` (the card unless ``"cpu"``;
    raises before running anything when no card is visible)."""
    dev = str(resolve_device(device))
    names = select(only)
    records, errors, timings = [], {}, {}
    for name in names:
        spec = registry.get(name)
        takes_device = "device" in inspect.signature(spec.fn).parameters
        t0 = time.perf_counter()
        try:
            recs = spec.run(mode, {"device": dev} if takes_device else None)
        except Exception as e:
            errors[name] = f"{type(e).__name__}: {e}"
            if verbose:
                traceback.print_exc()
            continue
        finally:
            timings[name] = time.perf_counter() - t0
        for r in recs:
            if r.benchmark != name:
                errors[name] = f"record {r.name!r} claims benchmark {r.benchmark!r}"
                break
        else:
            records.extend(recs)
        if verbose:
            print(f"  {name}: {len(recs)} records in {timings[name]:.1f}s")
    result = BenchResult(
        mode=mode,
        env=EnvFingerprint.capture(dev),
        records=records,
        errors=errors,
        timings=timings,
    )
    if out_path:
        result.save(out_path)
    return result
