"""Fig 4.2 / Tab 4.3 analogue — matmul arithmetic throughput across dtypes
and sizes (Tensor Core study).

Port of ``repro.bench.suites.gemm``, with its record names, units and ``x``.
The measured rows come from the card (or the host with ``device="cpu"``);
the modeled rows report the roofline-bounded matrix-unit throughput of the
TPU v5e model and the paper's T4 peaks, both from the port's spec database,
as the reference's do."""
from __future__ import annotations

from repro_torch.core import probes
from repro_torch.core.autotune import choose_matmul_tiles
from repro_torch.core.registry import register
from repro_torch.hw import T4_PAPER, TPU_V5E

from ..schema import BenchRecord
from ._skip import skipped_on_cpu


@register(
    "gemm",
    paper_ref="Fig 4.2 / Tab 4.3",
    description="matmul throughput across dtypes",
    quick={"sizes": (256, 512)},
    full={"sizes": (256, 512, 1024, 2048)},
)
def bench_gemm(sizes=(256, 512), device="cuda") -> list:
    res = probes.probe_matmul_throughput(sizes=sizes, dtypes=("float32",), device=device)
    recs = []
    for key, g in zip(res.x, res.y):
        n = int(key.split(":")[1])
        recs.append(
            BenchRecord(
                name=f"gemm_host_{key}",
                benchmark="gemm",
                x=key,
                value=g,
                unit="GFLOP/s",
                metrics={"us_per_call": 2 * n**3 / (g * 1e9) * 1e6},
            )
        )
    for dt in ("bfloat16", "int8"):
        peak = TPU_V5E.peak(dt)
        eb = 2 if dt == "bfloat16" else 1
        for n in (1024, 4096, 8192):
            flops = 2 * n**3
            t = max(flops / peak, 3 * n * n * eb / TPU_V5E.main_memory_Bps)
            tile = choose_matmul_tiles(n, n, n, dt)
            recs.append(
                BenchRecord(
                    name=f"gemm_tpu_model_{dt}_{n}",
                    benchmark="gemm",
                    x=f"{dt}:{n}",
                    value=flops / t / 1e12,
                    unit="TFLOP/s",
                    measured=False,
                    metrics={"us_per_call": t * 1e6},
                    info=f"roofline-bounded MXU, tiles=({tile.bm},{tile.bk},{tile.bn})",
                )
            )
    for dt, v in T4_PAPER.peak_flops.items():
        recs.append(
            BenchRecord(
                name=f"gemm_t4_paper_{dt}",
                benchmark="gemm",
                x=dt,
                value=v / 1e12,
                unit="TFLOP/s",
                better="info",
                measured=False,
                info="paper Tab 4.3 measured T4 peak (cross-check anchor)",
            )
        )
    return recs


@register(
    "gemm",
    backends=("cuda", "torch"),
    paper_ref="Fig 4.2 / Tab 4.3",
    description="matmul throughput through the kernel dispatch API",
    quick={"sizes": (256, 512)},
    full={"sizes": (256, 512, 1024)},
)
def bench_gemm_backend(sizes=(256, 512), backend="torch", device="cuda") -> list:
    """The same GEMM measurement registered once per kernel backend —
    ``gemm[cuda]`` vs ``gemm[torch]`` is the paper's hand-kernel-vs-library
    side by side on one results file.  Tiles come from ``core.autotune`` via
    the policy.  The hand kernels need the card: on a CPU device the
    ``cuda`` variant measures nothing and says so in a ``gemm_skipped`` row."""
    from repro_torch.kernels.api import kernel_policy

    skipped = skipped_on_cpu("gemm", len(sizes), backend, device)
    if skipped:
        return skipped
    with kernel_policy(autotune=True):
        res = probes.probe_matmul_throughput(
            sizes=sizes, dtypes=("float32",), backend=backend, device=device
        )
    recs = []
    for key, g in zip(res.x, res.y):
        n = int(key.split(":")[1])
        recs.append(
            BenchRecord(
                name=f"gemm_dispatch_{key}",
                benchmark="gemm",
                x=key,
                value=g,
                unit="GFLOP/s",
                metrics={"us_per_call": 2 * n**3 / (g * 1e9) * 1e6},
                info=f"{backend} backend",
            )
        )
    return recs
