"""Benchmark suites — importing this package registers every ported
paper-table benchmark with ``repro_torch.core.registry``.

Paper map (table/figure -> registered name):

    Fig 1.1            axpy        access-width sweep on bandwidth-bound axpy
    Tab 2.1            scheduler   work-unit/execution-unit occupancy
    Fig 3.5 / Tab 3.1  memhier     pointer-chase hierarchy dissection
    Tab 3.2/3.4,
    Fig 3.12/3.13      bandwidth   per-level streaming bandwidth
    Tab 4.1            instr       dependent-issue op latency
    Tab 4.2 / Fig 4.1  atomics     scatter contention
    Fig 4.2 / Tab 4.3  gemm        matmul throughput across dtypes
    Tab 3.1 / Tab 4.3  gemm_lp     low-precision TensorCore ladder vs spec DB
    Fig 4.3-4.5        throttle    power/thermal clock governor
    Ch. 3+4 (whole)    dissect     probe suite -> fitted HardwareModel
    Ch.1 + Fig 4.3     serving     serving engine under sustained load
    Ch.1               serving_scaled  serving cluster over a device sweep
    §4.5               serving_chaos   cluster goodput/availability under faults
"""
from . import (  # noqa: F401  (import side effect: registration)
    atomics,
    axpy,
    bandwidth,
    dissect,
    gemm,
    gemm_lp,
    instr,
    memhier,
    scheduler,
    serving,
    serving_chaos,
    serving_scaled,
    throttle,
)
