#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:

1. the card's name and power limit (nvidia-smi);
2. build the hand kernels from ``src/repro_torch/kernels/csrc`` (timed);
3. each kernel at the shapes the main path gives it: run, compare with its
   plain PyTorch version on the same inputs (tolerance stated per kernel),
   and time kernel, plain version and, where one exists, one PyTorch library
   call of the same function, beside the least time the card could take;
4. the main path: ``python -m repro_torch.bench run dissect --full`` through
   the CLI function, with the launch counts zeroed before and read after; the
   pointer-chase, stream and matmul probes must have gone through the
   kernels; the fitted model is checked and compared with the H100 datasheet;
5. ``probe_block_shape_bandwidth`` (the Ch. 1 axpy experiment), counted the
   same way, and the access-width sweep of Fig 1.1 at an HBM-sized array;
6. a ``kernels`` line, one JSON line of per-kernel numbers, and the final
   ``{"ok": true, "device": ...}`` line.

Rates used for the bounds (NVIDIA H100 SXM data sheet): 3.35 TB/s HBM,
67 TFLOP/s fp32 outside the tensor cores.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
KERNELS = ("pchase", "stream_reduce", "axpy", "matmul")
SOURCES = {
    "pchase": ("src/repro_torch/kernels/csrc/pchase.cu", "src/repro/kernels/pchase.py:22"),
    "stream_reduce": ("src/repro_torch/kernels/csrc/membw.cu", "src/repro/kernels/membw.py:39"),
    "axpy": ("src/repro_torch/kernels/csrc/axpy.cu", "src/repro/kernels/axpy.py:16"),
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:58"),
}


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls,
    bracketed by CUDA events after ``warmup`` calls.  A spin kernel of 2^18
    cycles per call (about 130 us) runs first, so the host enqueues the calls while the
    device is busy and the bracket holds device work, not Python dispatch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters << 18)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def check_close(name, got, want, rtol, atol) -> float:
    err = max_abs_err(got, want)
    limit = atol + rtol * float(want.double().abs().max())
    if not (err <= limit and got.shape == want.shape):
        raise AssertionError(f"{name}: max |err| {err} > {limit} (rtol {rtol}, atol {atol})")
    return err


def kernel_checks(torch, dev) -> dict:
    """Phase 3: each kernel against its plain version at main-path shapes."""
    from repro_torch import hw
    from repro_torch.core.pchase import single_cycle_permutation
    from repro_torch.kernels import ref
    from repro_torch.kernels.axpy import axpy_cuda
    from repro_torch.kernels.matmul import matmul_cuda
    from repro_torch.kernels.membw import stream_reduce
    from repro_torch.kernels.pchase import pchase_cuda, pchase_torch

    rows = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    # pchase: the largest full-mode footprint (128 MiB, HBM-resident), full-mode steps
    n, steps = 1 << 25, 1 << 17
    t0 = time.perf_counter()
    perm = torch.from_numpy(single_cycle_permutation(n, 0)).to(dev)
    print(f"host: Sattolo permutation of {n} entries in {time.perf_counter() - t0:.1f} s")
    got = pchase_cuda(perm, steps)
    torch.cuda.synchronize()
    plain = pchase_torch(perm, steps)
    host = ref.pchase_ref(perm, steps)
    if int(got[0, 0]) != int(plain[0, 0]) or int(got[0, 0]) != host:
        raise AssertionError(f"pchase: kernel {int(got[0, 0])}, plain {int(plain[0, 0])}, host {host}")
    # spec-sheet latency of the level that holds what the walk touches: one
    # 32-byte sector per step, a single cycle, so min(steps, n) sectors
    touched = min(steps, n) * 32
    level = next(l for l in hw.get("h100").levels if l.size_bytes == 0 or touched <= l.size_bytes)
    rows["pchase"] = {
        "shape": f"perm ({n},) int32, steps {steps}", "tolerance": "exact",
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: pchase_cuda(perm, steps), 3, warmup=1),
        "plain_ms": time_ms(torch, lambda: pchase_torch(perm, steps), 1, warmup=1),
        "library_ms": None,
        "bound_ms": (min(steps, n) * 4 + 4) / HBM_BPS * 1e3, "bound_by": "bytes",
        "latency_bound_ms": steps * level.latency_ns * 1e-6, "latency_level": level.name,
    }
    del perm

    # stream_reduce: the largest full-mode footprint, (65536, 512) f32 = 128 MiB
    x = torch.rand((65536, 512), generator=gen, device=dev)
    err = check_close("stream_reduce", stream_reduce(x), ref.reduce_ref(x), 1e-4, 0.0)
    ones = torch.ones((4096, 512), device=dev)  # 8 MiB: every partial sum stays below 2^24
    if float(stream_reduce(ones)[0, 0]) != float(ones.numel()):
        raise AssertionError("stream_reduce: all-ones checksum is not exact")
    rows["stream_reduce"] = {
        "shape": "(65536, 512) float32", "tolerance": "rtol 1e-4; 8 MiB of ones exact",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: stream_reduce(x), 20),
        "plain_ms": time_ms(torch, lambda: ref.reduce_ref(x), 20),
        "library_ms": time_ms(torch, lambda: torch.sum(x), 20),
        "bound_ms": (x.numel() * 4 + 4) / HBM_BPS * 1e3, "bound_by": "bytes",
    }
    del x, ones

    # axpy: the probe's 1 MiB footprint at its middle tile width, 16-byte accesses
    x = torch.randn((512, 512), generator=gen, device=dev)
    y = torch.randn((512, 512), generator=gen, device=dev)
    err = check_close("axpy", axpy_cuda(x, y, 2.0), ref.axpy_ref(x, y, 2.0), 1e-5, 1e-5)
    xb, yb = x.bfloat16(), y.bfloat16()
    check_close("axpy bf16", axpy_cuda(xb, yb, 2.0), ref.axpy_ref(xb, yb, 2.0), 2e-2, 2e-2)
    rows["axpy"] = {
        "shape": "(512, 512) float32, tile (8, 512), 16-byte accesses",
        "tolerance": "rtol 1e-5, atol 1e-5 (bf16: 2e-2)", "max_abs_err": err,
        "ms": time_ms(torch, lambda: axpy_cuda(x, y, 2.0), 200),
        "plain_ms": time_ms(torch, lambda: ref.axpy_ref(x, y, 2.0), 200),
        "library_ms": time_ms(torch, lambda: torch.add(y, x, alpha=2.0), 200),
        "bound_ms": 3 * x.numel() * 4 / HBM_BPS * 1e3, "bound_by": "bytes",
    }

    # matmul: the largest full-mode size, fp32 with no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    nn = 2048
    a = torch.randn((nn, nn), generator=gen, device=dev) * 0.3
    b = torch.randn((nn, nn), generator=gen, device=dev) * 0.3
    err = check_close("matmul", matmul_cuda(a, b), ref.matmul_ref(a, b), 1e-4, 1e-4)
    ab, bb = a.bfloat16(), b.bfloat16()
    check_close("matmul bf16", matmul_cuda(ab, bb), ref.matmul_ref(ab, bb), 3e-2, 3e-2)
    rows["matmul"] = {
        "shape": "(2048, 2048) @ (2048, 2048) float32", "tolerance": "rtol 1e-4, atol 1e-4",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: matmul_cuda(a, b), 10),
        "plain_ms": time_ms(torch, lambda: ref.matmul_ref(a, b), 10),
        "library_ms": time_ms(torch, lambda: torch.matmul(a, b), 10),
        "bound_ms": max(2 * nn**3 / FP32_FLOPS, 3 * nn * nn * 4 / HBM_BPS) * 1e3,
        "bound_by": "operations",
    }
    for name, r in rows.items():
        print(f"check {name}: {r['shape']}; max_abs_err {r['max_abs_err']} ({r['tolerance']}); "
              f"kernel {r['ms']} ms, plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']} ms ({r['bound_by']})", flush=True)
    print(f"check pchase latency chain at the datasheet's {rows['pchase']['latency_level']} "
          f"latency: {rows['pchase']['latency_bound_ms']} ms (spec-sheet figure)", flush=True)
    return rows


def main_path(torch, dev) -> tuple:
    """Phase 4: ``bench run dissect --full`` through the CLI function."""
    from repro_torch import hw
    from repro_torch.bench import cli
    from repro_torch.bench.suites import dissect as dissect_suite
    from repro_torch.kernels import _util

    reports = []
    measure = dissect_suite.dissect_measure

    def keep_report(*args, **kw):  # the suite reports fitted numbers; keep the probes too
        rep = measure(*args, **kw)
        reports.append(rep)
        return rep

    dissect_suite.dissect_measure = keep_report
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dissect.json")
        t0 = time.perf_counter()
        _util.reset_launch_counts()
        rc = cli.main(["run", "dissect", "--full", "--out", out])
        counts = _util.launch_counts()
        seconds = time.perf_counter() - t0
        dissect_suite.dissect_measure = measure
        if rc != 0:
            raise RuntimeError(f"bench run dissect --full exited {rc}")
        with open(out) as f:
            result = json.load(f)
    print(f"dissect --full: {seconds:.1f} s; launches {counts}", flush=True)
    (rep,) = reports
    for probe in ("pointer_chase", "stream_bandwidth", "matmul_throughput"):
        backend = rep.probe_results[probe]["meta"]["backend"]
        if backend != "cuda":
            raise AssertionError(f"{probe} ran on backend {backend!r}, not the cuda kernels")
    for k in ("pchase", "stream_reduce", "matmul"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{k} kernel was not launched on the main path")
    if result["env"]["device_kind"] != torch.cuda.get_device_name(dev):
        raise AssertionError(f"result env names {result['env']['device_kind']!r}")
    recs = {r["name"]: r["value"] for r in result["records"]}
    want = {"dissect_host_stream_bw", "dissect_host_matmul_peak", "dissect_host_n_levels",
            "dissect_tpu_model_hbm_bw", "dissect_tpu_model_bf16_peak"}
    if not want <= set(recs) or not all(math.isfinite(v) and v > 0 for v in recs.values()):
        raise AssertionError(f"dissect records missing or not finite and positive: {recs}")
    fitted = rep.hardware
    if not 0 < fitted.peak("float32") <= 1.05 * FP32_FLOPS:
        raise AssertionError(f"fitted fp32 peak {fitted.peak('float32')} is outside (0, 67T]")
    pc = rep.probe_results["pointer_chase"]
    print("pointer chase ns/load by footprint: "
          + ", ".join(f"{x}:{y:.1f}" for x, y in zip(pc["x"], pc["y"])), flush=True)
    sb = rep.probe_results["stream_bandwidth"]
    print("stream GB/s by footprint: "
          + ", ".join(f"{x}:{y:.1f}" for x, y in zip(sb["x"], sb["y"])), flush=True)
    mm = rep.probe_results["matmul_throughput"]
    print("matmul GFLOP/s: " + ", ".join(f"{x}:{y:.1f}" for x, y in zip(mm["x"], mm["y"])))
    ops = rep.probe_results["op_latency"]
    print("op_latency ns/op (eager, one launch per op): "
          + ", ".join(f"{x}:{y:.1f}" for x, y in zip(ops["x"], ops["y"])), flush=True)
    print(f"fitted levels (latency ns, capacity bytes): {rep.detected_levels}")
    print(f"fitted stream {fitted.main_memory_Bps / 1e9} GB/s, "
          f"fp32 {fitted.peak('float32') / 1e9} GFLOP/s", flush=True)
    cmp = hw.compare("measured-host", "h100")
    print("compare(measured-host, h100): " + json.dumps(
        {k: cmp[k] for k in ("peak_ratio", "main_memory_Bps_ratio", "levels")}), flush=True)
    return counts, seconds


def axpy_path(torch, dev) -> dict:
    """Phase 5: the Ch. 1 experiment as the probe runs it, then Fig 1.1's
    access-width sweep at an array far past the 50 MB L2."""
    from repro_torch.core import probes
    from repro_torch.kernels import _util

    _util.reset_launch_counts()
    res = probes.probe_block_shape_bandwidth(device=dev)
    counts = _util.launch_counts()
    if res.meta["backend"] != "cuda" or counts.get("axpy", 0) <= 0:
        raise AssertionError(f"block-shape probe bypassed the axpy kernel: {res.meta} {counts}")
    print("block_shape_bandwidth GB/s by tile width (1 MiB arrays): "
          + ", ".join(f"{x}:{y:.1f}" for x, y in zip(res.x, res.y)) + f"; launches {counts}")
    for vb in (4, 8, 16):
        big = probes.probe_block_shape_bandwidth(
            footprint=256 << 20, col_widths=(2048,), device=dev, vec_bytes=vb)
        print(f"access width {vb * 8}-bit, 256 MiB arrays: {big.y[0]:.1f} GB/s", flush=True)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from repro_torch.kernels import _util

    t0 = time.perf_counter()
    lib = _util.build_library()
    _util.library()
    print(f"built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.1f} s", flush=True)

    rows = kernel_checks(torch, dev)
    counts, _ = main_path(torch, dev)
    counts.update(axpy_path(torch, dev))

    print("kernels: " + " ".join(KERNELS))
    line = []
    for name in KERNELS:
        r = rows[name]
        src, replaces = SOURCES[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts.get(name, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        if "latency_bound_ms" in r:
            entry["latency_bound_ms"] = r["latency_bound_ms"]
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
