"""Tab 2.1 analogue — work-unit <-> execution-unit mapping.

Port of ``repro.bench.suites.scheduler``, with its record names.  The paper
shows warps colliding on a Turing scheduler (same index mod 4) halve
throughput.  ``probe_grid_occupancy`` reads ``stream_reduce`` throughput as
the array grows in units of ``rows_per_program`` rows (the reference's
programs of a TPU grid); the card's kernel sizes its own grid, so the ratio
to one unit reads how throughput grows with the work in flight."""
from __future__ import annotations

from repro_torch.core import probes
from repro_torch.core.registry import register

from ..schema import BenchRecord
from ._skip import skipped_on_cpu


@register(
    "scheduler",
    paper_ref="Tab 2.1",
    description="work-unit/execution-unit occupancy",
    quick={"rows_per_program": 64, "programs": (1, 2, 3, 4, 6, 8)},
    full={"rows_per_program": 256, "programs": (1, 2, 3, 4, 6, 8)},
)
def bench_scheduler(rows_per_program=64, programs=(1, 2, 3, 4, 6, 8), device="cuda") -> list:
    res = probes.probe_grid_occupancy(
        rows_per_program=rows_per_program, programs=programs, device=device
    )
    base = res.y[0] or 1.0
    return [
        BenchRecord(
            name=f"grid_occupancy_p{p}",
            benchmark="scheduler",
            x=p,
            value=bw,
            unit="GB/s",
            metrics={"ratio_vs_1program": bw / base},
            info=f"{res.meta['backend']} backend, {bw / base:.2f}x of 1-program",
        )
        for p, bw in zip(res.x, res.y)
    ]


@register(
    "scheduler",
    backends=("cuda", "torch"),
    paper_ref="Tab 2.1",
    description="grid occupancy through the kernel dispatch API",
    quick={"rows_per_program": 32, "programs": (1, 2, 4)},
    full={"rows_per_program": 256, "programs": (1, 2, 3, 4, 6, 8)},
)
def bench_scheduler_backend(rows_per_program=32, programs=(1, 2, 4), backend="torch",
                            device="cuda") -> list:
    """Occupancy sweep once per kernel backend: the cuda rows are the hand
    kernel under study, the torch rows the plain version (``x.sum()``) —
    the Tab 2.1 contrast as a results-file diff."""
    skipped = skipped_on_cpu("scheduler", len(programs), backend, device)
    if skipped:
        return skipped
    res = probes.probe_grid_occupancy(
        rows_per_program=rows_per_program, programs=programs, backend=backend, device=device
    )
    base = res.y[0] or 1.0
    return [
        BenchRecord(
            name=f"grid_occupancy_dispatch_p{p}",
            benchmark="scheduler",
            x=p,
            value=bw,
            unit="GB/s",
            metrics={"ratio_vs_1program": bw / base},
            info=f"{backend} backend, {bw / base:.2f}x of 1-program",
        )
        for p, bw in zip(res.x, res.y)
    ]
