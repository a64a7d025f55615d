"""Tab 3.1 / 4.3 low-precision GEMM suite — the paper's TensorCore story.

Port of ``repro.bench.suites.gemm_lp``, with its record names, units, ``x``
and grids.  The headline of the T4 dissection is the per-dtype throughput
ladder: fp16 TensorCore matmul runs ~5.8x fp32, int8 ~1.8x fp16 (Table 4.3).
This suite measures that ladder as schema-v1 records — a dtype x size sweep
where each product accumulates wide (int8 -> int32, floats -> fp32) — plus
the *modeled* ladder for a reference part from :mod:`repro_torch.hw`, so a
results file carries both the measurement and the paper-anchored ratios it
is validated against.

Registered per backend: ``gemm_lp[cuda]`` runs the hand kernels through
``api.matmul.bound(..., out_dtype=acc, backend="cuda")`` (float32 on the FP32
pipes, the rest on the tensor cores); ``gemm_lp[torch]`` plays the
reference's ``xla`` variant, the library path: ``torch.matmul`` for the
floats (cuBLAS accumulates them in fp32 and returns the input's type),
``torch._int_mm`` for int8 and ``torch._scaled_mm`` with unit scales and an
fp32 output for fp8 (B handed over column-major, as it requires, made
before the timing).  Points a backend or platform cannot run (the cuda
variant on a CPU device) are skipped and listed in a ``gemm_lp_skipped``
row, as the reference does.
"""
from __future__ import annotations

import torch

import repro_torch.hw as hw_db
from repro_torch.core.registry import register
from repro_torch.core.timing import time_fn
from repro_torch.kernels import api

from ..schema import BenchRecord

_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}
_ACC_DTYPES = {"int8": torch.int32}  # everything else accumulates in fp32

# ratio records anchor each precision against fp32 (the paper's Tab 4.3
# presentation: "fp16 runs 5.8x fp32, int8 10.4x"), plus the int8-vs-fp16
# TensorCore step the T4 story highlights
_RATIO_ANCHOR = "float32"
_EXTRA_RATIOS = (("int8", "float16"),)


def _library_fn(a: torch.Tensor, b: torch.Tensor):
    """The library product of ``a @ b`` with a wide accumulator, and its
    operands."""
    if a.dtype == torch.int8:
        return torch._int_mm, (a, b)
    if a.dtype == torch.float8_e4m3fn:
        one = torch.ones((), device=a.device)
        b_cols = b.t().contiguous().t()

        def scaled(a, b):
            return torch._scaled_mm(a, b, scale_a=one, scale_b=one, out_dtype=torch.float32)

        return scaled, (a, b_cols)
    return torch.matmul, (a, b)


def _measure_one(n: int, dtype: str, backend: str, device: str):
    """GFLOP/s of an n^3 matmul in ``dtype`` on ``backend`` (None if the
    dtype cannot run there)."""
    tdt = _TORCH_DTYPES[dtype]
    acc = _ACC_DTYPES.get(dtype, torch.float32)
    try:
        a = torch.ones((n, n), dtype=tdt, device=device)
        b = torch.ones((n, n), dtype=tdt, device=device)
        if backend == "torch":
            fn, args = _library_fn(a, b)
        else:
            fn, args = api.matmul.bound(a, b, out_dtype=acc, backend=backend), (a, b)
        t = time_fn(fn, *args, warmup=2, reps=5)
    except Exception:  # unsupported dtype on this backend/platform
        return None
    return 2 * n**3 / t.min_s / 1e9


@register(
    "gemm_lp",
    backends=("cuda", "torch"),
    paper_ref="Tab 3.1 / Tab 4.3 (TensorCore dtypes)",
    description="low-precision matmul throughput: dtype x size sweep + modeled ladder",
    quick={"sizes": (128, 256), "dtypes": ("float32", "bfloat16", "int8")},
    full={
        "sizes": (256, 512, 1024),
        "dtypes": ("float32", "bfloat16", "float16", "int8", "float8_e4m3fn"),
    },
)
def bench_gemm_lp(
    sizes=(128, 256),
    dtypes=("float32", "bfloat16", "int8"),
    hw="T4",
    backend="torch",
    device="cuda",
) -> list:
    part = hw_db.resolve(hw)
    recs, skipped, measured = [], [], {}
    for dt in dtypes:
        for n in sizes:
            g = _measure_one(n, dt, backend, device)
            if g is None:
                skipped.append(f"{dt}:{n}")
                continue
            measured[(dt, n)] = g
            recs.append(
                BenchRecord(
                    name=f"gemm_lp_{dt}:{n}",
                    benchmark="gemm_lp",
                    x=f"{dt}:{n}",
                    value=g,
                    unit="GFLOP/s",
                    metrics={"us_per_call": 2 * n**3 / (g * 1e9) * 1e6},
                    info=f"{backend} backend, wide accumulate",
                )
            )
    # measured dtype ratios at the largest size — the device's own ladder
    top = max(sizes)
    for dt in dtypes:
        if dt != _RATIO_ANCHOR and (dt, top) in measured and (_RATIO_ANCHOR, top) in measured:
            recs.append(
                BenchRecord(
                    name=f"gemm_lp_measured_ratio_{dt}_over_{_RATIO_ANCHOR}",
                    benchmark="gemm_lp",
                    x=f"{dt}/{_RATIO_ANCHOR}",
                    value=measured[(dt, top)] / measured[(_RATIO_ANCHOR, top)],
                    unit="x",
                    better="info",
                    info=f"measured ladder at n={top} on {device}",
                )
            )
    # the modeled ladder from the spec DB: per-dtype peaks for the reference
    # part and the paper-anchored ratios the validation test asserts on
    for dt in part.dtypes():
        recs.append(
            BenchRecord(
                name=f"gemm_lp_model_{part.name}_{dt}",
                benchmark="gemm_lp",
                x=dt,
                value=part.peak(dt) / 1e12,
                unit="TFLOP/s",
                measured=False,
                info=f"spec-DB peak ({part.source})",
            )
        )
    ratio_pairs = [
        (dt, _RATIO_ANCHOR) for dt in part.dtypes() if dt != _RATIO_ANCHOR
    ] + list(_EXTRA_RATIOS)
    for hi, lo in ratio_pairs:
        if part.supports(lo) and part.supports(hi):
            recs.append(
                BenchRecord(
                    name=f"gemm_lp_model_{part.name}_ratio_{hi}_over_{lo}",
                    benchmark="gemm_lp",
                    x=f"{hi}/{lo}",
                    value=part.peak(hi) / part.peak(lo),
                    unit="x",
                    better="info",
                    measured=False,
                    info="modeled dtype ladder (paper Tab 4.3 for T4)",
                )
            )
    if skipped:
        recs.append(
            BenchRecord(
                name="gemm_lp_skipped",
                benchmark="gemm_lp",
                x=None,
                value=float(len(skipped)),
                unit="points",
                better="info",
                info="unsupported on this backend/platform: " + ", ".join(skipped),
            )
        )
    return recs
