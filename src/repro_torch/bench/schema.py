"""Versioned benchmark-result schema.

One serialization shared by the benchmark runner and the dissect report:
every measurement is a ``BenchRecord`` (name, sweep coordinate, primary
value + unit, regression direction, derived metrics); a run is a
``BenchResult`` (schema version, mode, env fingerprint, records, per-
benchmark errors/timings).  The JSON layout is what CI artifacts, the
baseline store, and the ``compare`` gate all consume.

Regression direction (``better``) is inferred from the unit when not given:
time-like units gate on increases, rate-like units on decreases, and
``"info"`` rows (paper cross-checks, detected capacities) are never gated.
``measured`` distinguishes wall-clock measurements (noisy across machines,
wide default threshold) from deterministic model outputs (tight threshold).
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field, fields
from pathlib import Path
from typing import Union

from repro_torch.core.serialization import (  # noqa: F401  (re-exported schema surface)
    SCHEMA_VERSION,
    EnvFingerprint,
    finite,
    probe_to_dict,
)

_LOWER_BETTER_UNITS = {"s", "ms", "us", "ns", "us/call", "ns/load", "ns/op"}
_HIGHER_BETTER_UNITS = {"GB/s", "TB/s", "GFLOP/s", "TFLOP/s", "Mupdates/s", "MHz"}

BETTER_VALUES = ("lower", "higher", "info")


class SchemaError(ValueError):
    """A results document does not conform to the schema."""


def better_for_unit(unit: str) -> str:
    if unit in _LOWER_BETTER_UNITS:
        return "lower"
    if unit in _HIGHER_BETTER_UNITS:
        return "higher"
    return "info"


@dataclass(frozen=True)
class BenchRecord:
    """One measurement row (one point of a benchmark's sweep)."""

    name: str  # unique row id within a run, e.g. "axpy_pallas_n1048576_w512"
    benchmark: str  # registered benchmark that produced it
    x: Union[float, int, str, None]  # sweep coordinate
    value: float  # primary metric
    unit: str
    better: str = ""  # "lower" | "higher" | "info"; inferred from unit if ""
    measured: bool = True  # wall-clock measurement vs deterministic model
    metrics: dict = field(default_factory=dict)  # derived metrics, numeric
    info: str = ""  # human-readable annotation

    def __post_init__(self):
        if not self.better:
            object.__setattr__(self, "better", better_for_unit(self.unit))
        if self.better not in BETTER_VALUES:
            raise SchemaError(f"{self.name}: bad better={self.better!r}")


@dataclass
class BenchResult:
    """A full benchmark run, ready for JSON round-trip."""

    mode: str  # "quick" | "full"
    env: EnvFingerprint
    records: list  # list[BenchRecord]
    errors: dict = field(default_factory=dict)  # benchmark -> error string
    timings: dict = field(default_factory=dict)  # benchmark -> seconds
    created_at: str = ""
    schema_version: int = SCHEMA_VERSION

    def __post_init__(self):
        if not self.created_at:
            self.created_at = time.strftime("%Y-%m-%dT%H:%M:%S%z")

    # -- accessors ---------------------------------------------------------
    def benchmarks(self) -> list:
        return sorted({r.benchmark for r in self.records})

    def by_name(self) -> dict:
        return {r.name: r for r in self.records}

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "created_at": self.created_at,
            "mode": self.mode,
            "env": asdict(self.env),
            "records": [asdict(r) for r in self.records],
            "errors": dict(self.errors),
            "timings": {k: round(v, 3) for k, v in self.timings.items()},
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path) -> None:
        Path(path).write_text(self.to_json() + "\n")

    @staticmethod
    def from_dict(d: dict) -> "BenchResult":
        validate_result(d)
        return BenchResult(
            mode=d["mode"],
            env=env_from_dict(d["env"]),
            records=[BenchRecord(**r) for r in d["records"]],
            errors=dict(d.get("errors", {})),
            timings=dict(d.get("timings", {})),
            created_at=d.get("created_at", ""),
            schema_version=d["schema_version"],
        )

    @staticmethod
    def from_json(s: str) -> "BenchResult":
        return BenchResult.from_dict(json.loads(s))

    @staticmethod
    def load(path) -> "BenchResult":
        return BenchResult.from_json(Path(path).read_text())


def env_from_dict(env: dict) -> EnvFingerprint:
    """The env of a results document: the port's fingerprint, or the one
    ``repro.bench`` writes (its JAX versions have no field here and are
    dropped, the torch and CUDA versions left blank), so both packages' gates
    and trends read a results file of either."""
    if set(env) == _ENV_KEYS:
        return EnvFingerprint(**env)
    if set(env) == _REFERENCE_ENV_KEYS:
        return EnvFingerprint(torch_version="", cuda_version="",
                              **{k: env[k] for k in _ENV_KEYS & _REFERENCE_ENV_KEYS})
    raise SchemaError(f"env keys {sorted(env)} are neither the port's nor repro's")


_ENV_KEYS = {f.name for f in fields(EnvFingerprint)}
_REFERENCE_ENV_KEYS = {"jax_version", "jaxlib_version", "backend", "device_kind",
                       "device_count", "platform", "python_version"}


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------
_RESULT_KEYS = {"schema_version", "mode", "env", "records"}
_RECORD_KEYS = {"name", "benchmark", "value", "unit"}


def validate_result(d: dict) -> None:
    """Raise SchemaError if ``d`` is not a valid results document."""
    if not isinstance(d, dict):
        raise SchemaError(f"results document must be an object, got {type(d).__name__}")
    missing = _RESULT_KEYS - set(d)
    if missing:
        raise SchemaError(f"missing result keys: {sorted(missing)}")
    if d["schema_version"] != SCHEMA_VERSION:
        raise SchemaError(
            f"schema_version {d['schema_version']} != supported {SCHEMA_VERSION}"
        )
    if not isinstance(d["records"], list):
        raise SchemaError("records must be a list")
    seen = set()
    for i, r in enumerate(d["records"]):
        missing = _RECORD_KEYS - set(r)
        if missing:
            raise SchemaError(f"record[{i}] missing keys: {sorted(missing)}")
        if not isinstance(r["value"], (int, float)):
            raise SchemaError(f"record {r['name']!r}: value must be numeric")
        if r.get("better", "") not in BETTER_VALUES + ("",):
            raise SchemaError(f"record {r['name']!r}: bad better={r['better']!r}")
        if r["name"] in seen:
            raise SchemaError(f"duplicate record name {r['name']!r}")
        seen.add(r["name"])
