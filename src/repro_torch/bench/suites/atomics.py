"""Tab 4.2 / Fig 4.1 analogue — update throughput under contention.

Port of ``repro.bench.suites.atomics``, with its record names.  The
reference times an XLA scatter-add (a TPU has no hardware atomics); its
counterpart here is ``Tensor.index_add``, which on the card adds with
atomics, so the colliding updates contend on real ``atomicAdd``s as in the
paper's scenarios.  No hand kernel stands behind it: the reference has no
Pallas kernel for it either."""
from __future__ import annotations

from repro_torch.core import probes
from repro_torch.core.registry import register

from ..schema import BenchRecord


@register(
    "atomics",
    paper_ref="Tab 4.2 / Fig 4.1",
    description="scatter-add contention",
    quick={"n_updates": 1 << 14, "collisions": (1, 2, 4, 8, 16, 32)},
    full={"n_updates": 1 << 18, "collisions": (1, 2, 4, 8, 16, 32)},
)
def bench_atomics(n_updates=1 << 14, collisions=(1, 2, 4, 8, 16, 32), device="cuda") -> list:
    res = probes.probe_scatter_contention(n_updates=n_updates, collisions=collisions,
                                          device=device)
    return [
        BenchRecord(
            name=f"scatter_contention_x{c}",
            benchmark="atomics",
            x=c,
            value=r,
            unit="Mupdates/s",
            metrics={"us_per_call": n_updates / (r * 1e6) if r else 0.0},
            info=f"{c} colliding updates per address",
        )
        for c, r in zip(res.x, res.y)
    ]
