"""Benchmark suites — importing this package registers every ported
paper-table benchmark with ``repro_torch.core.registry``.

Paper map (table/figure -> registered name):

    Ch. 3+4 (whole)    dissect     probe suite -> fitted HardwareModel

The other suites of ``repro.bench.suites`` are still to be ported.
"""
from . import dissect  # noqa: F401  (import side effect: registration)
