"""dissect() — orchestrates the probe suite into a fitted HardwareModel,
the executable version of the paper's whole Chapter 3 + 4 workflow.

measure mode: runs every probe on the given device — the card by default,
where the hand kernels carry the pointer-chase, streaming and GEMM probes —
and fits a model of it.

model mode: evaluates the same probe grid analytically against any part in
the :mod:`repro_torch.hw` spec database (``hw=`` takes a name like ``"T4"``
or a ``HardwareModel``; default TPU v5e).  :func:`dissect_compare` runs model
mode across several generations and emits the paper's T4-vs-P4-vs-V100
comparison as records.

Measure mode registers the fitted model into the same database (via
``fit_from_probes``), so a dissected card is immediately comparable:
``repro_torch.hw.compare("measured-host", "h100")``.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Iterable, Optional, Union

from repro_torch.hw import HardwareModel, fit_from_probes
from repro_torch.hw import compare as _hw_compare
from repro_torch.hw import resolve as _resolve_hw

from . import probes
from .serialization import SCHEMA_VERSION, EnvFingerprint, probe_to_dict
from .timing import resolve_device


@dataclass
class DissectReport:
    mode: str
    hardware: HardwareModel
    probe_results: dict  # name -> ProbeResult-as-dict (bench.schema probe layout)
    detected_levels: list  # [(latency_ns, capacity_bytes|None)]
    device: str = "cpu"  # where measure mode ran; model mode computes on the host

    def to_json(self) -> str:
        """Serialize on the shared bench schema (version + env fingerprint),
        so dissect reports and bench results are one JSON dialect."""
        return json.dumps(
            {
                "schema_version": SCHEMA_VERSION,
                "kind": "dissect_report",
                "mode": self.mode,
                "env": asdict(EnvFingerprint.capture(self.device)),
                "hardware": json.loads(self.hardware.to_json()),
                "probes": self.probe_results,
                "detected_levels": self.detected_levels,
            },
            indent=2,
        )


def dissect_measure(
    quick: bool = True, out_path: Optional[str] = None, device: str = "cuda"
) -> DissectReport:
    """Run the full probe suite on ``device`` and fit a HardwareModel.

    Raises :class:`repro_torch.core.timing.NoCudaDeviceError` when no card is
    visible and ``device`` was not set to ``"cpu"``.
    """
    dev = resolve_device(device)
    sizes = [1 << p for p in range(12, 25 if quick else 28)]
    steps = 1 << (14 if quick else 17)
    res_pc = probes.probe_pointer_chase(sizes, steps=steps, device=dev)
    plats, caps = probes.analyze_pointer_chase(res_pc)
    detected = [
        (p.latency, caps[i] if i < len(caps) else None) for i, p in enumerate(plats)
    ]

    res_bw = probes.probe_stream_bandwidth(
        [1 << p for p in range(18, 24 if quick else 28)], device=dev
    )
    stream_bps = max(res_bw.y) * 1e9

    res_mm = probes.probe_matmul_throughput(
        sizes=(256, 512) if quick else (256, 512, 1024, 2048), device=dev
    )
    flops = {"float32": max(res_mm.y) * 1e9}

    res_ops = probes.probe_op_latency(chain=1024 if quick else 8192, device=dev)

    hw = fit_from_probes(
        name="measured-host",
        plateau_levels=detected,
        stream_Bps=stream_bps,
        matmul_flops=flops,
    )
    report = DissectReport(
        mode="measure",
        hardware=hw,
        probe_results={
            r.name: probe_to_dict(r) for r in (res_pc, res_bw, res_mm, res_ops)
        },
        detected_levels=detected,
        device=str(dev),
    )
    if out_path:
        Path(out_path).write_text(report.to_json())
    return report


# ---------------------------------------------------------------------------
# model mode: analytic predictions over the same probe grid
# ---------------------------------------------------------------------------
def _predict_pchase(hw: HardwareModel, sizes) -> list[float]:
    lat = []
    for s in sizes:
        for lvl in hw.levels:
            if lvl.size_bytes == 0 or s <= lvl.size_bytes:
                lat.append(lvl.latency_ns)
                break
        else:
            lat.append(hw.levels[-1].latency_ns)
    return lat


def _predict_stream(hw: HardwareModel, sizes) -> list[float]:
    out = []
    for s in sizes:
        for lvl in hw.levels:
            if lvl.bandwidth_Bps and (lvl.size_bytes == 0 or s <= lvl.size_bytes):
                out.append(lvl.bandwidth_Bps / 1e9)
                break
        else:
            out.append(hw.main_memory_Bps / 1e9)
    return out


def _predict_matmul(hw: HardwareModel, sizes, dtype="bfloat16") -> list[float]:
    peak = hw.peak(dtype, fallback=("float16", "float32"))
    eb = {"float64": 8, "float32": 4, "int8": 1}.get(dtype, 2)
    out = []
    for n in sizes:
        flops = 2 * n**3
        t_compute = flops / peak
        t_mem = 3 * n * n * eb / hw.main_memory_Bps
        out.append(flops / max(t_compute, t_mem) / 1e9)
    return out


def dissect_model(
    hw: Union[str, HardwareModel] = "tpu-v5e",
    out_path: Optional[str] = None,
    dtype: str = "bfloat16",
) -> DissectReport:
    hw = _resolve_hw(hw)
    sizes = [1 << p for p in range(12, 31)]
    bw_sizes = [1 << p for p in range(18, 31)]
    mm_sizes = (256, 512, 1024, 2048, 4096, 8192)
    report = DissectReport(
        mode="model",
        hardware=hw,
        probe_results={
            "pointer_chase": {
                "x": sizes, "y": _predict_pchase(hw, sizes), "unit": "ns/load", "meta": {},
            },
            "stream_bandwidth": {
                "x": bw_sizes, "y": _predict_stream(hw, bw_sizes), "unit": "GB/s", "meta": {},
            },
            "matmul_throughput": {
                "x": [f"{dtype}:{n}" for n in mm_sizes],
                "y": _predict_matmul(hw, mm_sizes, dtype), "unit": "GFLOP/s", "meta": {},
            },
        },
        detected_levels=[(l.latency_ns, l.size_bytes or None) for l in hw.levels],
    )
    if out_path:
        Path(out_path).write_text(report.to_json())
    return report


def dissect_compare(
    hws: Iterable[Union[str, HardwareModel]] = ("P4", "T4", "V100"),
    baseline: Union[str, HardwareModel] = "T4",
    dtypes: Optional[Iterable[str]] = None,
) -> dict:
    """Model-mode dissection across generations — the paper's comparison
    tables as one record.

    Runs :func:`dissect_model` for every part and pairs each against
    ``baseline`` with :func:`repro_torch.hw.compare`.  The default grid is
    the paper's own column set (P4/T4/V100); pass successors ("A100", "H100",
    "B200") to extend the table the way the sequel dissections do.
    """
    base = _resolve_hw(baseline)
    parts = [_resolve_hw(h) for h in hws]
    return {
        "baseline": base.name,
        "parts": [h.name for h in parts],
        "reports": {h.name: dissect_model(h).probe_results for h in parts},
        "comparisons": {
            h.name: _hw_compare(h, base, dtypes=dtypes)
            for h in parts
            if h.name != base.name
        },
    }
