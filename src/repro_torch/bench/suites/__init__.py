"""Benchmark suites — importing this package registers every ported
paper-table benchmark with ``repro_torch.core.registry``.

Paper map (table/figure -> registered name):

    Fig 4.2 / Tab 4.3  gemm        matmul throughput across dtypes
    Tab 3.1 / Tab 4.3  gemm_lp     low-precision TensorCore ladder vs spec DB
    Ch. 3+4 (whole)    dissect     probe suite -> fitted HardwareModel

The other suites of ``repro.bench.suites`` are still to be ported.
"""
from . import dissect, gemm, gemm_lp  # noqa: F401  (import side effect: registration)
