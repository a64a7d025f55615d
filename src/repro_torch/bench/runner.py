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

import torch

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
    guard: Optional[str] = None,
) -> BenchResult:
    """Run the selected benchmarks on ``device`` (the card unless ``"cpu"``;
    raises before running anything when no card is visible).

    With ``guard`` set (``"sample"`` / ``"shadow"``) the whole run executes
    under the numerics guard (``kernel_policy(guard=...)``): a fresh guard
    state (its tolerances for the H100 on the card, for the reference's
    default part on the CPU), a canonical shadow-verification sweep of every
    probe-registered kernel op up front (timing loops use ``op.bound()`` and
    are deliberately guard-free, so the sweep is what makes a clean-run drift
    gate meaningful), and the guard's schema-v1 activity records appended to
    the result.
    """
    dev = str(resolve_device(device))
    names = select(only)
    records, errors, timings = [], {}, {}
    if guard is not None:
        from repro_torch.kernels import api as kapi
        from repro_torch.kernels import guard as kguard

        on_card = torch.device(dev).type == "cuda"
        kguard.reset(kguard.GuardConfig(hw="nvidia-h100-sxm") if on_card else None)
        sweep = kguard.verify_ops()
        if verbose:
            ok = sum(r.ok for r in sweep.values())
            print(f"  guard: verified {ok}/{len(sweep)} kernel ops clean")
    for name in names:
        spec = registry.get(name)
        takes_device = "device" in inspect.signature(spec.fn).parameters
        t0 = time.perf_counter()
        try:
            overrides = {"device": dev} if takes_device else None
            if guard is not None:
                with kapi.kernel_policy(guard=guard):
                    recs = spec.run(mode, overrides)
            else:
                recs = spec.run(mode, overrides)
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
    if guard is not None:
        records.extend(kguard.metrics().to_records("guard", "guard", x=guard))
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
