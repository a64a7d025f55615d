"""Fig 3.5 / Tab 3.1 / Fig 3.6 analogue — memory-hierarchy dissection via
fine-grained pointer chase.

Port of ``repro.bench.suites.memhier``, with its record names: measured on
the device the run asks for (on the card the ``pchase`` kernel walks the
card's L1/L2/HBM; the ``*_host_*`` names are the reference's), plus the
reference's modeled TPU v5e hierarchy (``pchase_tpu_model_*``, not the
card's).  At these grids' steps the walk touches a few MiB at most, which
stays in the H100's 50 MB L2.
"""
from __future__ import annotations

from repro_torch.core import probes
from repro_torch.core.registry import register
from repro_torch.hw import TPU_V5E

from ..schema import BenchRecord
from ._skip import skipped_on_cpu


@register(
    "memhier",
    paper_ref="Fig 3.5 / Tab 3.1",
    description="pointer-chase hierarchy dissection",
    quick={"min_pow": 12, "max_pow": 25, "steps": 1 << 14},
    full={"min_pow": 12, "max_pow": 28, "steps": 1 << 14},
)
def bench_memhier(min_pow=12, max_pow=25, steps=1 << 14, device="cuda") -> list:
    sizes = [1 << p for p in range(min_pow, max_pow)]
    res = probes.probe_pointer_chase(sizes, steps=steps, device=device)
    plats, caps = probes.analyze_pointer_chase(res)
    recs = [
        BenchRecord(
            name=f"pchase_host_{s >> 10}KiB",
            benchmark="memhier",
            x=s,
            value=lat,
            unit="ns/load",
            metrics={"us_per_call": lat * 1e-3},
            info=f"{res.meta['backend']} backend",
        )
        for s, lat in zip(res.x, res.y)
    ]
    for i, p in enumerate(plats):
        recs.append(
            BenchRecord(
                name=f"pchase_host_level{i}",
                benchmark="memhier",
                x=i,
                value=p.latency,
                unit="ns",
                better="info",  # plateau count/capacity varies across devices
                metrics={"capacity_bytes": int(p.end_size)},
                info=f"capacity~{p.end_size >> 10}KiB latency {p.latency:.2f}ns",
            )
        )
    for lvl in TPU_V5E.levels:
        recs.append(
            BenchRecord(
                name=f"pchase_tpu_model_{lvl.name}",
                benchmark="memhier",
                x=lvl.name,
                value=lvl.latency_ns,
                unit="ns/load",
                measured=False,
                metrics={"size_bytes": lvl.size_bytes},
                info=f"size {lvl.size_bytes >> 20}MiB lat {lvl.latency_ns:.0f}ns",
            )
        )
    return recs


@register(
    "memhier",
    backends=("cuda", "torch"),
    paper_ref="Fig 3.5 / Tab 3.1",
    description="pointer-chase latency through the kernel dispatch API",
    quick={"min_pow": 12, "max_pow": 16, "steps": 1 << 12},
    full={"min_pow": 12, "max_pow": 22, "steps": 1 << 14},
)
def bench_memhier_backend(min_pow=12, max_pow=16, steps=1 << 12, backend="torch",
                          device="cuda") -> list:
    """The dependent-load walk once per kernel backend — the paper's
    fine-grained-pchase-vs-library contrast (§3.1) as ``memhier[cuda]`` vs
    ``memhier[torch]`` rows in one results file."""
    sizes = [1 << p for p in range(min_pow, max_pow)]
    skipped = skipped_on_cpu("memhier", len(sizes), backend, device)
    if skipped:
        return skipped
    res = probes.probe_pointer_chase(sizes, steps=steps, backend=backend, device=device)
    return [
        BenchRecord(
            name=f"pchase_dispatch_{s >> 10}KiB",
            benchmark="memhier",
            x=s,
            value=lat,
            unit="ns/load",
            metrics={"us_per_call": lat * 1e-3},
            info=f"{backend} backend",
        )
        for s, lat in zip(res.x, res.y)
    ]
