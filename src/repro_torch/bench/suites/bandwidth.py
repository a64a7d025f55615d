"""Tab 3.2 / Tab 3.4 / Fig 3.12 / Fig 3.13 analogue — per-level streaming
bandwidth + block-shape (access-width) sweep.

Port of ``repro.bench.suites.bandwidth``, with its record names.  On the
card the stream rows time the ``stream_reduce`` kernel and the width rows
the ``axpy`` kernel; the ``*_tpu_model_*`` rows are the reference's TPU v5e
model, not the card's.  ``bandwidth[cuda]`` / ``bandwidth[torch]`` take the
place of the reference's ``[pallas]`` / ``[xla]``: the hand kernel against
the plain PyTorch version on one results file."""
from __future__ import annotations

from repro_torch.core import probes
from repro_torch.core.registry import register
from repro_torch.hw import TPU_V5E

from ..schema import BenchRecord
from ._skip import skipped_on_cpu


@register(
    "bandwidth",
    paper_ref="Tab 3.2/3.4, Fig 3.12/3.13",
    description="per-level streaming bandwidth",
    quick={"min_pow": 18, "max_pow": 24, "block_footprint": 1 << 22},
    full={"min_pow": 18, "max_pow": 28, "block_footprint": 1 << 22},
)
def bench_bandwidth(min_pow=18, max_pow=24, block_footprint=1 << 22, device="cuda") -> list:
    recs = []
    res = probes.probe_stream_bandwidth([1 << p for p in range(min_pow, max_pow)],
                                        device=device)
    for f, bw in zip(res.x, res.y):
        recs.append(
            BenchRecord(
                name=f"streambw_host_{f >> 10}KiB",
                benchmark="bandwidth",
                x=f,
                value=bw,
                unit="GB/s",
                metrics={"us_per_call": f / (bw * 1e9) * 1e6},
                info=f"{res.meta['backend']} backend",
            )
        )
    blk = probes.probe_block_shape_bandwidth(footprint=block_footprint, device=device)
    for w, bw in zip(blk.x, blk.y):
        recs.append(
            BenchRecord(
                name=f"axpybw_host_width{w}",
                benchmark="bandwidth",
                x=w,
                value=bw,
                unit="GB/s",
                metrics={"us_per_call": block_footprint * 12 / (bw * 1e9) * 1e6},
                info=f"{blk.meta['backend']} backend",
            )
        )
    for lvl in TPU_V5E.levels:
        if lvl.bandwidth_Bps:
            recs.append(
                BenchRecord(
                    name=f"streambw_tpu_model_{lvl.name}",
                    benchmark="bandwidth",
                    x=lvl.name,
                    value=lvl.bandwidth_Bps / 1e9,
                    unit="GB/s",
                    measured=False,
                    info=f"{lvl.name} modeled sustained bandwidth",
                )
            )
    return recs


@register(
    "bandwidth",
    backends=("cuda", "torch"),
    paper_ref="Tab 3.2/3.4, Fig 3.12/3.13",
    description="streaming bandwidth through the kernel dispatch API",
    quick={"min_pow": 18, "max_pow": 21},
    full={"min_pow": 18, "max_pow": 25},
)
def bench_bandwidth_backend(min_pow=18, max_pow=21, backend="torch", device="cuda") -> list:
    """The same streaming-reduce measurement once per kernel backend —
    ``bandwidth[cuda]`` vs ``bandwidth[torch]`` restates the paper's
    hand-kernel-vs-library bandwidth columns on one results file."""
    footprints = [1 << p for p in range(min_pow, max_pow)]
    skipped = skipped_on_cpu("bandwidth", len(footprints), backend, device)
    if skipped:
        return skipped
    res = probes.probe_stream_bandwidth(footprints, backend=backend, device=device)
    return [
        BenchRecord(
            name=f"streambw_dispatch_{f >> 10}KiB",
            benchmark="bandwidth",
            x=f,
            value=bw,
            unit="GB/s",
            metrics={"us_per_call": f / (bw * 1e9) * 1e6},
            info=f"{backend} backend",
        )
        for f, bw in zip(res.x, res.y)
    ]
