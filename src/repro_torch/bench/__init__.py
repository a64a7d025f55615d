"""repro_torch.bench — the benchmark subsystem of the port.

Every paper-table benchmark registers with :mod:`repro_torch.core.registry`
(``@bench.register`` with paper ref + quick/full sweep grids), and the runner
executes them into one versioned JSON schema (:mod:`.schema`), the same
schema v1 as ``repro.bench``, and the baseline store (:mod:`.baseline`)
gates regressions against ``benchmarks/baselines_torch/``:

    python -m repro_torch.bench list
    python -m repro_torch.bench run --quick --out results.json
    python -m repro_torch.bench run dissect --device cpu
    python -m repro_torch.bench compare results.json benchmarks/baselines_torch/
"""
from repro_torch.core.registry import BenchSpec, register

from .baseline import CompareReport, compare, compare_files, load_baselines, write_baselines
from .runner import load_suites, run_benchmarks, select
from .schema import (
    SCHEMA_VERSION,
    BenchRecord,
    BenchResult,
    EnvFingerprint,
    SchemaError,
    validate_result,
)

__all__ = [
    "SCHEMA_VERSION",
    "BenchRecord",
    "BenchResult",
    "BenchSpec",
    "CompareReport",
    "EnvFingerprint",
    "SchemaError",
    "compare",
    "compare_files",
    "load_baselines",
    "load_suites",
    "register",
    "run_benchmarks",
    "select",
    "validate_result",
    "write_baselines",
]
