"""Whole-paper benchmark — the Ch. 3+4 workflow as one registered entry.

Runs the full probe suite (measure mode: the card unless ``device="cpu"``),
fits a HardwareModel, and reports the fitted summary; then evaluates the
analytic TPU v5e model over the same grid.  Record names are those of
``repro.bench.suites.dissect``.  This entry gates the *fitted* quantities the
rest of the stack consumes (stream bandwidth, matmul peak, per-level
latency).
"""
from __future__ import annotations

from repro_torch.core.dissect import dissect_measure, dissect_model
from repro_torch.core.registry import register

from ..schema import BenchRecord


@register(
    "dissect",
    paper_ref="Ch. 3+4 (Tab 3.1 workflow)",
    description="probe suite -> fitted HardwareModel",
    quick={"quick": True},
    full={"quick": False},
)
def bench_dissect(quick=True, device="cuda") -> list:
    rep = dissect_measure(quick=quick, device=device)
    recs = [
        BenchRecord(
            name="dissect_host_stream_bw",
            benchmark="dissect",
            x="measured-host",
            value=rep.hardware.main_memory_Bps / 1e9,
            unit="GB/s",
            info="fitted main-memory streaming bandwidth",
        ),
        BenchRecord(
            name="dissect_host_matmul_peak",
            benchmark="dissect",
            x="measured-host",
            value=rep.hardware.peak("float32") / 1e9,
            unit="GFLOP/s",
            info="fitted f32 matmul peak",
        ),
        BenchRecord(
            name="dissect_host_n_levels",
            benchmark="dissect",
            x="measured-host",
            value=float(len(rep.detected_levels)),
            unit="levels",
            better="info",
            info="detected memory-hierarchy plateaus",
        ),
    ]
    for i, (lat, cap) in enumerate(rep.detected_levels):
        recs.append(
            BenchRecord(
                name=f"dissect_host_level{i}_latency",
                benchmark="dissect",
                x=i,
                value=float(lat),
                unit="ns",
                better="info",  # plateau segmentation varies across hosts
                metrics={"capacity_bytes": int(cap) if cap else 0},
            )
        )
    model = dissect_model()
    hw = model.hardware
    recs += [
        BenchRecord(
            name="dissect_tpu_model_hbm_bw",
            benchmark="dissect",
            x=hw.name,
            value=hw.main_memory_Bps / 1e9,
            unit="GB/s",
            measured=False,
            info="modeled HBM bandwidth",
        ),
        BenchRecord(
            name="dissect_tpu_model_bf16_peak",
            benchmark="dissect",
            x=hw.name,
            value=hw.peak("bfloat16") / 1e12,
            unit="TFLOP/s",
            measured=False,
            info="modeled MXU bf16 peak",
        ),
    ]
    return recs
