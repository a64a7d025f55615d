"""Fig 1.1 analogue — `?axpy` access-width sweep.

Port of ``repro.bench.suites.axpy``, with its record names.  The paper:
cublasSaxpy's 64-bit loads vs. hand-vectorized 128-bit loads -> ~2x on large
arrays.  Here the bandwidth-bound axpy is swept over tile widths through
``api.axpy`` (the ``axpy`` kernel on the card, its plain version on the
CPU), beside the library baseline (the reference's ``axpy_xla_baseline_*``
row: one PyTorch call, ``torch.add(y, x, alpha=2.5)``) and the reference's
HBM-bound TPU v5e model (``axpy_tpu_modeled_*``, not the card's).
"""
from __future__ import annotations

import torch

from repro_torch.core.registry import register
from repro_torch.core.timing import resolve_device, time_fn
from repro_torch.hw import TPU_V5E
from repro_torch.kernels import api

from ..schema import BenchRecord
from ._skip import skipped_on_cpu


def _ones(n: int, cols: int, dev) -> torch.Tensor:
    return torch.ones((n // cols, cols), dtype=torch.float32, device=dev)


@register(
    "axpy",
    paper_ref="Fig 1.1",
    description="access-width sweep on bandwidth-bound axpy",
    quick={"sizes": (1 << 18, 1 << 20), "widths": (128, 256, 512, 1024)},
    full={"sizes": (1 << 18, 1 << 20, 1 << 22), "widths": (128, 256, 512, 1024, 2048)},
)
def bench_axpy(sizes=(1 << 18, 1 << 20), widths=(128, 256, 512, 1024), device="cuda") -> list:
    dev = resolve_device(device)
    be = api.resolve_backend(None, dev)
    recs = []
    for n in sizes:
        x, y = _ones(n, 512, dev), _ones(n, 512, dev)
        bytes_moved = 3 * n * 4  # 2 reads + 1 write

        t_lib = time_fn(lambda a, b: torch.add(b, a, alpha=2.5), x, y, warmup=2, reps=5)
        recs.append(
            BenchRecord(
                name=f"axpy_xla_baseline_n{n}",
                benchmark="axpy",
                x=n,
                value=bytes_moved / t_lib.min_s / 1e9,
                unit="GB/s",
                metrics={"us_per_call": t_lib.min_s * 1e6},
                info="PyTorch library baseline, one torch.add(y, x, alpha=2.5)",
            )
        )
        for w in widths:
            xv, yv = _ones(n, w, dev), _ones(n, w, dev)
            t = time_fn(
                api.axpy.bound(xv, yv, 2.5, block_rows=8, block_cols=w),
                xv, yv, 2.5, warmup=2, reps=5,
            )
            recs.append(
                BenchRecord(
                    name=f"axpy_pallas_n{n}_w{w}",
                    benchmark="axpy",
                    x=w,
                    value=bytes_moved / t.min_s / 1e9,
                    unit="GB/s",
                    metrics={"us_per_call": t.min_s * 1e6, "size": n},
                    info=f"{be} backend, tile width {w}",
                )
            )
        recs.append(
            BenchRecord(
                name=f"axpy_tpu_modeled_n{n}",
                benchmark="axpy",
                x=n,
                value=TPU_V5E.main_memory_Bps / 1e9,
                unit="GB/s",
                measured=False,
                metrics={"us_per_call": bytes_moved / TPU_V5E.main_memory_Bps * 1e6},
                info="HBM-bandwidth-bound TPU v5e model",
            )
        )
    return recs


@register(
    "axpy",
    backends=("cuda", "torch"),
    paper_ref="Fig 1.1",
    description="access-width axpy sweep through the kernel dispatch API",
    quick={"size": 1 << 18, "widths": (256, 512)},
    full={"size": 1 << 20, "widths": (128, 256, 512, 1024)},
)
def bench_axpy_backend(size=1 << 20, widths=(256, 512), backend="torch", device="cuda") -> list:
    """Same measurement, one registered variant per kernel backend: the cuda
    rows vary with tile width, the torch rows are the width-insensitive plain
    version — the paper's Fig 1.1 comparison as a results-file diff."""
    skipped = skipped_on_cpu("axpy", len(widths), backend, device)
    if skipped:
        return skipped
    dev = resolve_device(device)
    recs = []
    bytes_moved = 3 * size * 4
    for w in widths:
        x, y = _ones(size, w, dev), _ones(size, w, dev)
        t = time_fn(
            api.axpy.bound(x, y, 2.5, block_rows=8, block_cols=w, backend=backend),
            x, y, 2.5, warmup=2, reps=5,
        )
        recs.append(
            BenchRecord(
                name=f"axpy_dispatch_n{size}_w{w}",
                benchmark="axpy",
                x=w,
                value=bytes_moved / t.min_s / 1e9,
                unit="GB/s",
                metrics={"us_per_call": t.min_s * 1e6, "size": size},
                info=f"{backend} backend, tile width {w}",
            )
        )
    return recs
