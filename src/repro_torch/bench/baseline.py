"""Baseline store + regression gate.

Port of ``repro.bench.baseline``.  The port's baselines live one file per
benchmark in ``benchmarks/baselines_torch/<name>.json`` (schema-versioned,
with the env fingerprint of the card run that produced them); the files are
schema v1, so either package's gate reads either directory.
``compare`` matches result records to baseline records by name and flags a
regression when the relative change in the worse direction exceeds the
record's threshold:

- ``better="lower"``  (latencies): regression = (cur - base) / base
- ``better="higher"`` (rates):     regression = (base - cur) / base
- ``better="info"``   rows are never gated.

Default thresholds: wall-clock measurements get a wide 0.75 (CI machines
vary; an injected 2x slowdown = 1.0 still trips), deterministic model
outputs get a tight 0.02.  Per-record ``threshold`` overrides are honored,
and ``threshold_scale`` loosens/tightens the whole gate at once.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

from .schema import SCHEMA_VERSION, BenchResult, SchemaError

DEFAULT_THRESHOLD_MEASURED = 0.75
DEFAULT_THRESHOLD_MODELED = 0.02
_CAP = 1e6  # JSON-safe stand-in for an unbounded regression (rate hit zero)


@dataclass(frozen=True)
class BaselineRecord:
    name: str
    value: float
    unit: str
    better: str
    measured: bool = True
    threshold: Optional[float] = None  # None -> default by `measured`

    def effective_threshold(self, scale: float = 1.0) -> float:
        base = (
            self.threshold
            if self.threshold is not None
            else DEFAULT_THRESHOLD_MEASURED
            if self.measured
            else DEFAULT_THRESHOLD_MODELED
        )
        return base * scale


@dataclass
class Delta:
    name: str
    benchmark: str
    baseline: float
    current: float
    unit: str
    better: str
    regression: float  # relative change in the worse direction
    threshold: float

    @property
    def exceeded(self) -> bool:
        return self.regression > self.threshold

    def describe(self) -> str:
        arrow = "slower" if self.better == "lower" else "lower-throughput"
        return (
            f"{self.name}: {self.baseline:.4g} -> {self.current:.4g} {self.unit} "
            f"({self.regression * 100:+.1f}% {arrow}, threshold {self.threshold * 100:.0f}%)"
        )


@dataclass
class CompareReport:
    regressions: list = field(default_factory=list)  # Delta, exceeded
    improvements: list = field(default_factory=list)  # Delta, better than -threshold
    within: int = 0  # gated records inside the threshold band
    new_records: list = field(default_factory=list)  # in results, no baseline
    missing_records: list = field(default_factory=list)  # in baseline, not in results
    zero_baselines: list = field(default_factory=list)  # baseline value 0: ungateable
    errors: dict = field(default_factory=dict)  # benchmark errors from the run

    @property
    def passed(self) -> bool:
        return not self.regressions and not self.errors

    def to_dict(self) -> dict:
        return {
            "passed": self.passed,
            "regressions": [asdict(d) for d in self.regressions],
            "improvements": [asdict(d) for d in self.improvements],
            "within_threshold": self.within,
            "new_records": self.new_records,
            "missing_records": self.missing_records,
            "zero_baselines": self.zero_baselines,
            "errors": dict(self.errors),
        }

    def format(self) -> str:
        lines = []
        if self.errors:
            lines.append(f"ERRORS ({len(self.errors)} benchmarks failed to run):")
            lines += [f"  {k}: {v}" for k, v in sorted(self.errors.items())]
        if self.regressions:
            lines.append(f"REGRESSIONS ({len(self.regressions)}):")
            lines += [f"  {d.describe()}" for d in self.regressions]
        if self.improvements:
            lines.append(f"improvements ({len(self.improvements)}):")
            lines += [f"  {d.describe()}" for d in self.improvements]
        lines.append(
            f"{self.within} records within threshold, "
            f"{len(self.new_records)} new, {len(self.missing_records)} missing baseline"
        )
        if self.zero_baselines:
            lines.append(
                f"warning: {len(self.zero_baselines)} zero-valued baselines cannot be "
                f"gated: {', '.join(self.zero_baselines)}"
            )
        lines.append("PASS" if self.passed else "FAIL")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------
def write_baselines(result: BenchResult, out_dir) -> list:
    """Write one baseline file per benchmark from a results document.

    Only gate-able rows (better != info) are stored.  Returns written paths.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for bench in result.benchmarks():
        recs = [
            {
                "name": r.name,
                "value": r.value,
                "unit": r.unit,
                "better": r.better,
                "measured": r.measured,
            }
            for r in result.records
            # value 0 cannot anchor a relative threshold — don't store it
            if r.benchmark == bench and r.better != "info" and r.value != 0
        ]
        doc = {
            "schema_version": SCHEMA_VERSION,
            "benchmark": bench,
            "generated_from": {"mode": result.mode, "env": asdict(result.env)},
            "records": recs,
        }
        p = out / f"{bench}.json"
        p.write_text(json.dumps(doc, indent=2) + "\n")
        paths.append(p)
    return paths


def load_baselines(baseline_dir) -> dict:
    """Load every baseline file in a directory -> {record name: (benchmark, BaselineRecord)}."""
    d = Path(baseline_dir)
    if not d.is_dir():
        raise SchemaError(f"baseline directory {d} does not exist")
    table = {}
    for p in sorted(d.glob("*.json")):
        doc = json.loads(p.read_text())
        if doc.get("schema_version") != SCHEMA_VERSION:
            raise SchemaError(
                f"{p}: schema_version {doc.get('schema_version')} != {SCHEMA_VERSION}"
            )
        bench = doc.get("benchmark", p.stem)
        for r in doc.get("records", []):
            table[r["name"]] = (bench, BaselineRecord(**r))
    return table


# ---------------------------------------------------------------------------
# gate
# ---------------------------------------------------------------------------
def compare(
    result: BenchResult, baselines: dict, threshold_scale: float = 1.0
) -> CompareReport:
    report = CompareReport(errors=dict(result.errors))
    seen = set()
    for rec in result.records:
        if rec.better == "info":
            continue
        entry = baselines.get(rec.name)
        if entry is None:
            report.new_records.append(rec.name)
            continue
        _, base = entry
        seen.add(rec.name)
        if base.value == 0:
            report.zero_baselines.append(rec.name)  # ungateable; surfaced, not silent
            continue
        # symmetric slowdown ratio: a 2x slowdown is 1.0 whether the unit is
        # time-like (value doubles) or rate-like (value halves)
        if base.better == "lower":
            regression = (rec.value - base.value) / abs(base.value)
        elif rec.value <= 0:
            regression = _CAP
        else:
            regression = min((base.value - rec.value) / abs(rec.value), _CAP)
        delta = Delta(
            name=rec.name,
            benchmark=rec.benchmark,
            baseline=base.value,
            current=rec.value,
            unit=rec.unit,
            better=base.better,
            regression=regression,
            threshold=base.effective_threshold(threshold_scale),
        )
        if delta.exceeded:
            report.regressions.append(delta)
        elif regression < -delta.threshold:
            report.improvements.append(delta)
        else:
            report.within += 1
    report.missing_records = sorted(set(baselines) - seen)
    report.regressions.sort(key=lambda d: -d.regression)
    return report


def compare_files(
    results_path, baseline_dir, threshold_scale: float = 1.0
) -> CompareReport:
    return compare(
        BenchResult.load(results_path), load_baselines(baseline_dir), threshold_scale
    )
