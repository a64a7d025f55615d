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
   pointer-chase, stream, matmul and op-latency probes must have gone through
   the kernels; the fitted model is checked and compared with the H100
   datasheet, and the op-latency table (ns per op) printed;
4b. the precision ladder: ``bench run gemm_lp[cuda] gemm_lp[torch] gemm[cuda]
   --full`` through the CLI function, counted the same way: every matmul
   instance (fp32, bf16, fp16, int8, fp8 and the 8-bit B transpose) must
   launch, no record may error or be skipped, and the measured ladder at the
   top size is printed beside the datasheet's;
4c. the paper's other tables: ``bench run instr bandwidth axpy memhier
   scheduler atomics throttle --full`` (every variant) through the CLI
   function, counted the same way and per registered benchmark: op_latency,
   stream_reduce, axpy and pchase must launch from the plain suites and the
   ``[cuda]`` variants, the ``[torch]`` ones launch nothing, and no record
   may error or be skipped; Tab 4.1, the memhier levels, stream GB/s, the
   atomics rates and the scheduler ratios are printed; the pointer chase is
   walked at 128 and 256 MiB, 2^21 steps, past the 50 MB L2; then a
   ``--quick`` run of every ported suite must PASS ``compare`` against
   ``benchmarks/baselines_torch/``, and FAIL with one latency record doubled;
5. ``probe_block_shape_bandwidth`` (the Ch. 1 axpy experiment), counted the
   same way, and the access-width sweep of Fig 1.1 at an HBM-sized array,
   each width counted on its own (phase 3 times the same sweep beside
   ``torch.add``; the kernels line carries both as axpy's ``sweep_256mib``);
6. the kernel layer's bandwidth entry points ``api.stream_copy`` and
   ``api.strided_reduce`` on 8 MiB of ones (exact sums), counted the same way;
7. the dense LM at gemma-2b's full width and depth, ``attn_impl="pallas"``,
   through ``build_model(cfg).prefill`` / ``decode_step``: 4 prompts of 1000
   tokens, 32 greedy steps, then one prompt of 2048; flash_attention must
   launch once per layer per prefill; the same requests through the plain
   ``attn_impl="blockwise"`` path are the reference; the plain prefill is
   counted once (``perfmodel.extract_costs``) and rooflined against the
   H100 at bf16, and the bound's share of the kernel path's prefill printed;
8. the Zamba2 hybrid LM at zamba2-7b's full width and depth (81 Mamba2
   layers, 14 shared-attention calls at hd 112), ``ssm_impl="pallas"`` and
   ``attn_impl="pallas"``, through ``build_model(cfg).loss_fn`` (81 ssm_scan
   launches, all on the wgmma route, and 14 flash_attention launches),
   ``prefill`` (14 flash_attention) and
   16 ``decode_step``s on 4 sequences of 1000 tokens; the same requests
   through the plain path (``ssm_impl="xla"``, ``attn_impl="blockwise"``)
   are the reference; then one forward under ``kernel_policy(autotune=True)``
   at the chunk the autotuner picks for the H100 (512), which must reach the
   ssm_scan kernel at that chunk and agree with the chunk-256 forward; the
   plain forward is rooflined as in phase 7;
9. a ``kernels`` line, one JSON line of per-kernel numbers, and the final
   ``{"ok": true, "device": ...}`` line.

Rates used for the bounds (NVIDIA H100 SXM data sheet): 3.35 TB/s HBM,
67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16 and fp16 dense on
them, 1,979 TFLOP/s (TOP/s) fp8 and int8.
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
BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12  # fp8 and int8 (TOP/s)
MATMUL_LP = {  # tensor-core instance: input dtype name, datasheet peak
    "matmul_bf16": ("bfloat16", BF16_FLOPS), "matmul_fp16": ("float16", BF16_FLOPS),
    "matmul_int8": ("int8", FP8_FLOPS), "matmul_fp8": ("float8_e4m3fn", FP8_FLOPS),
}
KERNELS = ("pchase", "stream_copy", "stream_reduce", "strided_reduce", "axpy", "matmul",
           *MATMUL_LP, "matmul_transpose", "flash_attention", "ssm_scan", "op_latency")
SOURCES = {
    "pchase": ("src/repro_torch/kernels/csrc/pchase.cu", "src/repro/kernels/pchase.py:22"),
    "stream_copy": ("src/repro_torch/kernels/csrc/membw.cu", "src/repro/kernels/membw.py:19"),
    "stream_reduce": ("src/repro_torch/kernels/csrc/membw.cu", "src/repro/kernels/membw.py:39"),
    "strided_reduce": ("src/repro_torch/kernels/csrc/membw.cu", "src/repro/kernels/membw.py:67"),
    "axpy": ("src/repro_torch/kernels/csrc/axpy.cu", "src/repro/kernels/axpy.py:16"),
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:58"),
    **{k: ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:58")
       for k in (*MATMUL_LP, "matmul_transpose")},
    "op_latency": ("src/repro_torch/kernels/csrc/op_latency.cu",
                   "src/repro/core/probes.py:149"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:49"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu", "src/repro/kernels/ssm_scan.py:17"),
}
LM_BATCH, LM_PROMPT, LM_STEPS, LM_LONG = 4, 1000, 32, 2048
ZAMBA_STEPS = 16
LOSS_RTOL = 1e-3  # zamba2 loss against the plain path, relative; measured ~2e-5
# flash_attention's bf16 rows against the plain version's fp32 output:
# max over rows of ||got - want|| / ||want||; p's and the output's bf16
# roundings come to a few 1e-3
FLASH_ROW_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}
# ssm_scan's bf16 rows against the plain version's fp32 output on the same
# bf16 inputs: y's own bf16 rounding measured 2.5e-3 (the kernel's error
# equal to it), so twice that
SSM_ROW_RTOL = 5e-3
# the same at a slow decay (-softplus(N(-5, 1))), where y's own bf16 rounding
# (row_rel_err_rounding_slow_decay) measured 2.571e-3 at chunk 256 and
# 2.621e-3 at chunk 512 on an H100, above the 2.5e-3 the rule above was set
# from: twice the larger
SSM_SLOW_ROW_RTOL = 2 * 2.621e-3
# fp16 inputs on the SIMT route (an fp32 state, as the reference's): one
# rounding of y to fp16, relative to max |y|, the card tests' fp16 limit
SSM_FP16_RTOL = 2e-3
# matmul's fp32 outputs, each row against the plain version's fp32 output:
# 16-bit inputs differ by the sum order (a few 1e-6 at K 4096); fp8 by the
# tensor cores' ~14-bit accumulation within each 128 of K (~1e-4, with the
# promotion to fp32 in between; the matmul_fp8 row of the run prints it).
# 16-bit outputs: twice the plain output's own rounding to that type,
# measured in the run.
MATMUL_F32_ROW_RTOL = {"bfloat16": 1e-5, "float16": 1e-5, "float8_e4m3fn": 5e-4}
MATMUL_SHAPES = ((2048, 2048, 2048), (4096, 4096, 4096), (300, 200, 100))
FLASH_MODEL_SHAPES = {"gemma-2b": (8, 1, 256), "zamba2-7b": (32, 32, 112)}  # H, Hkv, hd
MEMBW_SHAPE = (65536, 512)  # 128 MiB of fp32: the probes' largest footprint
# phase 4c: the paper's other suites, the kernels each registered variant must
# launch (exactly these; the [torch] variants and the rest launch none)
PAPER_SUITES = ("instr", "bandwidth", "axpy", "memhier", "scheduler", "atomics", "throttle")
SUITE_KERNELS = {
    "instr": {"op_latency"}, "bandwidth": {"stream_reduce", "axpy"},
    "bandwidth[cuda]": {"stream_reduce"}, "axpy": {"axpy"}, "axpy[cuda]": {"axpy"},
    "memhier": {"pchase"}, "memhier[cuda]": {"pchase"}, "scheduler": {"stream_reduce"},
    "scheduler[cuda]": {"stream_reduce"},
}
PORTED_SUITES = ("dissect", "gemm", *PAPER_SUITES)  # "gemm" takes gemm_lp and the variants
BASELINES = os.path.join(ROOT, "benchmarks", "baselines_torch")
GATE_PROBE = "oplat_fma.f32"  # the measured latency record doubled to show the gate fails
# the pointer chase past the 50 MB L2: footprints and steps (2^21 steps touch
# most of the 128 MiB array's 1 M 128-byte lines)
HBM_WALK_BYTES, HBM_WALK_STEPS = (128 << 20, 256 << 20), 1 << 21
AXPY_SWEEP_SHAPE = (32768, 2048)  # Fig 1.1's sweep: 256 MiB of fp32 an array


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


def row_rel_err(got, want) -> float:
    """The largest ||got - want|| / ||want|| over the rows of the last axis."""
    g, w = got.double(), want.double()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def check_rows(name, got, want, limit) -> float:
    """A limit on each row's relative error, where check_close's scales with
    the largest value of the whole output: a fault confined to rows whose
    values are small cannot hide under it."""
    err = row_rel_err(got, want)
    if not (err <= limit and got.shape == want.shape):
        raise AssertionError(f"{name}: max row ||err|| / ||want|| {err} > {limit}")
    return err


def kernel_checks(torch, dev) -> dict:
    """Phase 3: each kernel against its plain version at main-path shapes."""
    from repro_torch import hw
    from repro_torch.core.pchase import single_cycle_successors
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul_cuda
    from repro_torch.kernels.membw import stream_reduce
    from repro_torch.kernels.pchase import pchase_cuda, pchase_torch

    rows = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    # pchase: the largest full-mode footprint (128 MiB, HBM-resident), full-mode steps
    n, steps = 1 << 25, 1 << 17
    t0 = time.perf_counter()
    perm = single_cycle_successors(n, 0, dev)
    torch.cuda.synchronize()
    print(f"Sattolo permutation of {n} entries on the card in {time.perf_counter() - t0:.1f} s")
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

    rows["axpy"] = axpy_checks(torch, dev, gen)

    # matmul: the largest full-mode size, fp32 with no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    nn = 2048
    a = torch.randn((nn, nn), generator=gen, device=dev) * 0.3
    b = torch.randn((nn, nn), generator=gen, device=dev) * 0.3
    err = check_close("matmul", matmul_cuda(a, b), ref.matmul_ref(a, b), 1e-4, 1e-4)
    rows["matmul"] = {
        "shape": "(2048, 2048) @ (2048, 2048) float32", "tolerance": "rtol 1e-4, atol 1e-4",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: matmul_cuda(a, b), 10),
        "plain_ms": time_ms(torch, lambda: ref.matmul_ref(a, b), 10),
        "library_ms": time_ms(torch, lambda: torch.matmul(a, b), 10),
        "bound_ms": max(2 * nn**3 / FP32_FLOPS, 3 * nn * nn * 4 / HBM_BPS) * 1e3,
        "bound_by": "operations",
    }
    del a, b
    rows.update(matmul_lp_checks(torch, dev, gen))
    rows["stream_copy"] = copy_checks(torch, dev, gen)
    rows["strided_reduce"] = strided_checks(torch, dev, gen)
    rows["flash_attention"] = flash_checks(torch, dev, gen)
    rows["ssm_scan"] = ssm_checks(torch, dev, gen)
    rows["op_latency"] = op_latency_checks(torch, dev)
    for name, r in rows.items():
        print(f"check {name}: {r['shape']}; max_abs_err {r['max_abs_err']} ({r['tolerance']}); "
              f"kernel {r['ms']} ms, plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']} ms ({r['bound_by']})", flush=True)
    print(f"check pchase latency chain at the datasheet's {rows['pchase']['latency_level']} "
          f"latency: {rows['pchase']['latency_bound_ms']} ms (spec-sheet figure)", flush=True)
    return rows


def matmul_operands(torch, dev, gen, dtype, m, k, n):
    """Seeded operands: int8 uniform over its range, the floats N(0, 1) (fp8
    N(0, 2), so an fp8 output holds NaNs past 448 beside numbers)."""
    if dtype == torch.int8:
        return [torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int32)
                .to(dtype) for shape in ((m, k), (k, n))]
    scale = 2.0 if dtype == torch.float8_e4m3fn else 1.0
    return [(torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
            for shape in ((m, k), (k, n))]


def matmul_agreement(torch, name, got, a, b, out) -> dict:
    """``got`` (a @ b into ``out``) against the plain version: int outputs
    exact, saturation included; fp8 NaN at the same places away from the
    line of 464 (where the two fp32 sums may round either way) and within
    fp8's rounding elsewhere; the floats row by row against the plain fp32
    output (check_rows; limits at MATMUL_F32_ROW_RTOL)."""
    from repro_torch.kernels import ref

    want = ref.matmul_ref(a, b, out)
    if out in (torch.int32, torch.int8) or a.dtype == torch.int8:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: {int((got != want).sum())} entries differ from the "
                                 f"plain version's (exact expected)")
        return {"max_abs_err": 0.0}
    want32 = ref.matmul_ref(a, b, torch.float32)
    if out == torch.float8_e4m3fn:
        sure = (want32.abs() - ref.FP8_E4M3_NAN_PAST).abs() > 1e-3 * ref.FP8_E4M3_NAN_PAST
        gf, wf = got.float(), want.float()
        if not torch.equal(torch.isnan(gf)[sure], torch.isnan(wf)[sure]):
            raise AssertionError(f"{name}: NaN at other places than the plain version's")
        fin = ~torch.isnan(gf) & ~torch.isnan(wf)
        err = check_close(name, gf[fin], wf[fin], 0.125, 0.125)
        return {"max_abs_err": err, "nan_share": float(torch.isnan(gf).float().mean())}
    dt = str(a.dtype).removeprefix("torch.")
    limit = (MATMUL_F32_ROW_RTOL[dt] if out == torch.float32
             else 2 * row_rel_err(want32.to(out), want32))
    return {"max_abs_err": max_abs_err(got, want), "row_rel_err": check_rows(name, got, want32,
                                                                              limit),
            "row_rel_limit": limit}


def matmul_lp_checks(torch, dev, gen) -> dict:
    """The tensor-core matmul instances: each (input, output) pair the gemm
    suites run (into fp32, int32 for int8) and the default outputs (the input
    type: int8 saturating, fp8 NaN past 448) at 2048^3, 4096^3 and 300 x 200
    x 100, against the plain version; then each instance timed at 2048^3 and
    4096^3 beside the plain version, the library call (torch.matmul for
    bf16/fp16, torch._int_mm, torch._scaled_mm with unit scales and B handed
    over column-major, made untimed) and the bound, and the 8-bit B
    transpose on its own."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul_cuda, transpose8

    rows, transpose = {}, {}
    for kernel, (dt_name, peak) in MATMUL_LP.items():
        dtype = getattr(torch, dt_name)
        acc = torch.int32 if dtype == torch.int8 else torch.float32
        outs = (acc, dtype) + ((torch.bfloat16,) if dtype == torch.float8_e4m3fn else ())
        errs = {}
        for m, k, n in MATMUL_SHAPES:
            a, b = matmul_operands(torch, dev, gen, dtype, m, k, n)
            for out in outs:
                key = f"{str(out).removeprefix('torch.')}_{m}x{k}x{n}"
                errs[key] = matmul_agreement(
                    torch, f"{kernel} -> {out} at {m}x{k}x{n}",
                    matmul_cuda(a, b, out_dtype=out), a, b, out)
            if m not in (2048, 4096):
                continue
            es, oes = dtype.itemsize, acc.itemsize
            flops, nbytes = 2 * m * n * k, (m * k + k * n) * es + m * n * oes
            bound_ms, bound_by = bound(flops, nbytes, peak)
            if dtype == torch.int8:
                def library(a=a, b=b):
                    return torch._int_mm(a, b)
            elif dtype == torch.float8_e4m3fn:
                one, b_cols = torch.ones((), device=dev), b.t().contiguous().t()

                def library(a=a, b_cols=b_cols, one=one):
                    return torch._scaled_mm(a, b_cols, scale_a=one, scale_b=one,
                                            out_dtype=torch.float32)
            else:
                def library(a=a, b=b):
                    return torch.matmul(a, b)
            ms = time_ms(torch, lambda a=a, b=b: matmul_cuda(a, b, out_dtype=acc), 10)
            times = {"ms": ms, "tflops": flops / ms * 1e-9,
                     "library_ms": time_ms(torch, library, 10),
                     "bound_ms": bound_ms, "bound_by": bound_by}
            if m == 2048:
                times["plain_ms"] = time_ms(torch, lambda a=a, b=b: ref.matmul_ref(a, b, acc), 5)
            if dtype.itemsize == 1:  # the B^T pass, inside the timed call above
                times["transpose_ms"] = time_ms(torch, lambda b=b: transpose8(b), 10)
                if dtype == torch.int8:
                    tbytes = 2 * k * n
                    transpose[m] = {
                        "ms": times["transpose_ms"],
                        "plain_ms": time_ms(torch, lambda b=b: ref.transpose8_ref(b, k), 10),
                        "library_ms": time_ms(torch, lambda b=b: b.t().contiguous(), 10),
                        "bound_ms": tbytes / HBM_BPS * 1e3}
            if m == 4096:
                rows[kernel].update({f"{key}_4096": v for key, v in times.items()})
            else:
                rows[kernel] = {
                    "shape": f"(2048, 2048) @ (2048, 2048) {dt_name} -> {acc}".replace(
                        "torch.", ""), **times}
            del a, b
        rows[kernel].update({
            "tolerance": "int8: exact (int32 and saturating int8 outputs); floats: each row's "
                         "||err|| / ||want|| against the plain fp32 output within "
                         "MATMUL_F32_ROW_RTOL (fp32 out) or twice the plain output's own "
                         "rounding (16-bit out); fp8 out: NaN where the plain version's is, "
                         "away from 464, else rtol/atol 0.125; at 2048^3, 4096^3, 300x200x100",
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "row_rel_err": max((e.get("row_rel_err", 0.0) for e in errs.values()), default=0.0),
            "agreement": errs,
        })
        print(f"check {kernel}: {rows[kernel]}", flush=True)
    rows["matmul_transpose"] = {
        "shape": "int8 B (2048, 2048) -> B^T (2048, 2048)", "tolerance": "exact",
        "max_abs_err": 0.0, **transpose[2048], "bound_by": "bytes",
        **{f"{k}_4096": v for k, v in transpose[4096].items()},
    }
    for k, n in ((2048, 2048), (100, 200), (7, 33)):
        b = matmul_operands(torch, dev, gen, torch.int8, 1, k, n)[1]
        if not torch.equal(transpose8(b), ref.transpose8_ref(b, -(-k // 16) * 16)):
            raise AssertionError(f"matmul_transpose: B^T of ({k}, {n}) differs from the plain "
                                 f"version's")
    return rows


def axpy_checks(torch, dev, gen) -> dict:
    """axpy: one unroll at every access width (axpy_geometry, at the probe's
    and the sweep's shapes, and the built kernel's); the probe's 1 MiB footprint at its middle tile
    width with 16-byte accesses, timed; tiles of an odd number of vectors
    (never a multiple of the unroll; 4503 take a second, partial round) at
    every width in f32 and bf16; and Fig 1.1's sweep shape, (32768, 2048)
    f32 = 256 MiB an array in (8, 2048) tiles, at 4, 8 and 16 bytes, each
    timed beside ``torch.add`` at the same shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.axpy import VEC_BYTES, axpy_cuda, axpy_geometry, kernel_unroll

    unrolls = {(shape, vb): axpy_geometry(shape, 8, cols, vb, 4).unroll
               for shape, cols in (((512, 512), 512), (AXPY_SWEEP_SHAPE, AXPY_SWEEP_SHAPE[1]))
               for vb in VEC_BYTES}
    unrolls.update({("kernel", vb): kernel_unroll(vb) for vb in VEC_BYTES})
    if len(set(unrolls.values())) != 1:
        raise AssertionError(f"axpy: the unroll differs across widths (axpy_geometry at the "
                             f"probe's and the sweep's shapes, and the kernel's own): {unrolls}")
    x = torch.randn((512, 512), generator=gen, device=dev)
    y = torch.randn((512, 512), generator=gen, device=dev)
    err = check_close("axpy", axpy_cuda(x, y, 2.0), ref.axpy_ref(x, y, 2.0), 1e-5, 1e-5)
    xb, yb = x.bfloat16(), y.bfloat16()
    check_close("axpy bf16", axpy_cuda(xb, yb, 2.0), ref.axpy_ref(xb, yb, 2.0), 2e-2, 2e-2)
    row = {
        "shape": "(512, 512) float32, tile (8, 512), 16-byte accesses",
        "tolerance": "rtol 1e-5, atol 1e-5 (bf16: 2e-2)", "max_abs_err": err,
        "ms": time_ms(torch, lambda: axpy_cuda(x, y, 2.0), 200),
        "plain_ms": time_ms(torch, lambda: ref.axpy_ref(x, y, 2.0), 200),
        "library_ms": time_ms(torch, lambda: torch.add(y, x, alpha=2.0), 200),
        "bound_ms": 3 * x.numel() * 4 / HBM_BPS * 1e3, "bound_by": "bytes",
    }
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        item = torch.tensor([], dtype=dtype).element_size()
        for vb in VEC_BYTES:
            for row_vecs, block_rows in ((13, 3), (1501, 3)):
                cols = row_vecs * vb // item
                xe, ye = (torch.randn((2 * block_rows, 2 * cols), generator=gen, device=dev)
                          .to(dtype) for _ in range(2))
                check_close(f"axpy {dtype} tile ({block_rows}, {cols}), {vb}-byte accesses",
                            axpy_cuda(xe, ye, 2.0, block_rows=block_rows, block_cols=cols,
                                      vec_bytes=vb), ref.axpy_ref(xe, ye, 2.0), tol, tol)
    del x, y, xb, yb
    x = torch.randn(AXPY_SWEEP_SHAPE, generator=gen, device=dev)
    y = torch.randn(AXPY_SWEEP_SHAPE, generator=gen, device=dev)
    nbytes = 3 * x.numel() * 4
    library_ms = time_ms(torch, lambda: torch.add(y, x, alpha=2.0), 20)
    sweep = []
    for vb in VEC_BYTES:
        def run(vb=vb):
            return axpy_cuda(x, y, 2.0, block_cols=AXPY_SWEEP_SHAPE[1], vec_bytes=vb)

        e = check_close(f"axpy sweep {vb}-byte accesses", run(), ref.axpy_ref(x, y, 2.0),
                        1e-5, 1e-5)
        ms = time_ms(torch, run, 20)
        sweep.append({"vec_bytes": vb, "max_abs_err": e, "ms": ms, "gbps": nbytes / ms * 1e-6,
                      "bound_ms": nbytes / HBM_BPS * 1e3, "library_ms": library_ms})
    row["sweep_256mib"] = sweep
    print(f"check axpy Fig 1.1 sweep, {AXPY_SWEEP_SHAPE} f32, tile (8, 2048): {sweep}", flush=True)
    return row


def copy_checks(torch, dev, gen) -> dict:
    """stream_copy bit for bit in f32, bf16 and int32 at the probes' largest
    footprint, and at the edges of its rounds (below one, whole ones, 16
    bytes more, a tail of fewer than 16 bytes), timed at 128 MiB."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.membw import COPY_ROUND_BYTES, stream_copy

    x = torch.rand(MEMBW_SHAPE, generator=gen, device=dev)
    for xd in (x, (x * 1000).bfloat16(), (x * 1000).int()):
        if not torch.equal(stream_copy(xd), xd):
            raise AssertionError(f"stream_copy {xd.dtype}: the copy is not bit for bit")
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        item = torch.tensor([], dtype=dtype).element_size()
        for nbytes in (COPY_ROUND_BYTES - 48, 300 * COPY_ROUND_BYTES,
                       300 * COPY_ROUND_BYTES + 16, 300 * COPY_ROUND_BYTES + 16 - item):
            xe = (torch.rand((1, nbytes // item), generator=gen, device=dev) * 1000).to(dtype)
            if not torch.equal(stream_copy(xe, block_rows=1, block_cols=xe.shape[1]), xe):
                raise AssertionError(f"stream_copy {dtype} of {nbytes} bytes: not bit for bit")
    nbytes = x.numel() * 4
    return {
        "shape": "(65536, 512) float32, 128 MiB",
        "tolerance": "exact (f32, bf16, int32; also below one round, at 300 rounds and 16 bytes "
                     "and a short tail past them)", "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: stream_copy(x), 20),
        "plain_ms": time_ms(torch, lambda: ref.copy_ref(x), 20),
        "library_ms": time_ms(torch, lambda: x.clone(), 20),
        "bound_ms": 2 * nbytes / HBM_BPS * 1e3, "bound_by": "bytes",
    }


def strided_checks(torch, dev, gen) -> dict:
    """strided_reduce at the probes' largest footprint."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.membw import strided_reduce

    x = torch.rand(MEMBW_SHAPE, generator=gen, device=dev)
    errs, per_stride = [], {}
    for stride in (2, 3, 128):
        want = ref.strided_reduce_blocked_ref(x, stride, 64)
        errs.append(check_close(f"strided_reduce stride {stride}",
                                strided_reduce(x, stride=stride), want, 1e-4, 0.0))
        sel_rows = MEMBW_SHAPE[0] // 64 * -(-64 // stride)
        per_stride[stride] = {
            "ms": time_ms(torch, lambda s=stride: strided_reduce(x, stride=s), 20),
            "plain_ms": time_ms(torch, lambda s=stride: ref.strided_reduce_blocked_ref(x, s, 64), 20),
            "library_ms": (time_ms(torch, lambda s=stride: x[::s].sum(), 20)
                           if 64 % stride == 0 else None),
            "bound_ms": (sel_rows * MEMBW_SHAPE[1] * 4 + 4) / HBM_BPS * 1e3,
        }
        print(f"check strided_reduce stride {stride}: {per_stride[stride]}", flush=True)
    return {
        "shape": "(65536, 512) float32, block_rows 64, stride 2 (also 3, 128)",
        "tolerance": "rtol 1e-4 against the blocked plain version", "max_abs_err": max(errs),
        **per_stride[2], "bound_by": "bytes",
    }


def bound(flops: float, nbytes: float, peak: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM and operations over ``peak``."""
    by_ops, by_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def flash_model_case(torch, dev, gen, heads, kv_heads, hd) -> tuple:
    """One bf16 causal case in the model layout at the LMs' batch and prompt,
    q (B, S, heads, hd) and k/v (B, S, kv_heads, hd): the operands, their
    head-expanded (BH, S, hd) copies that the plain version takes, the
    kernel's output in that layout, and the plain version's fp32 output."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_model

    s = LM_PROMPT
    q = torch.randn((LM_BATCH, s, heads, hd), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((LM_BATCH, s, kv_heads, hd), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    flat = [t.repeat_interleave(heads // t.shape[2], 2).permute(0, 2, 1, 3)
            .reshape(-1, s, hd).contiguous() for t in (q, k, v)]
    got = flash_attention_model(q, k, v, causal=True).permute(0, 2, 1, 3).reshape(-1, s, hd)
    want32 = ref.flash_attention_ref(*(t.float() for t in flat), causal=True)
    return (q, k, v), flat, got, want32


def flash_agreement(name, got, want32, tol) -> dict:
    """``got`` against the plain version: within ``tol`` of its output in
    ``got``'s dtype (check_close), and row by row within FLASH_ROW_RTOL of
    its fp32 output; ``row_rel_err_rounding`` is what rounding that fp32
    output to ``got``'s dtype alone gives."""
    want = want32.to(got.dtype)
    rtol = FLASH_ROW_RTOL[str(got.dtype).removeprefix("torch.")]
    return {"max_abs_err": check_close(name, got.float(), want.float(), tol, tol),
            "row_rel_err": check_rows(name, got, want32, rtol),
            "row_rel_err_rounding": row_rel_err(want, want32)}


def flash_checks(torch, dev, gen) -> dict:
    """flash_attention at the LMs' shapes, bf16, causal, S 1000, in the model
    layout the LMs hand it: gemma-2b's q (4, 1000, 8, 256) over one KV head
    (native GQA), and zamba2-7b's q (4, 1000, 32, 112) at its native head
    width; each against its plain version and timed beside it and SDPA.
    Also the head-flattened entry point: bf16 at gemma's prompt of 2048
    (bq 128, bk 1024) and fp32 at S 256 on the FP32-pipe kernel."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_model

    def check_flat(dtype, s, bq, bk, tol, bh=32, hd=256):
        sq_pad = -(-s // bq) * bq
        q, k, v = [torch.randn((bh, n, hd), generator=gen, device=dev).to(dtype)
                   for n in (sq_pad, s, s)]
        got = flash_attention_cuda(q, k, v, causal=True, bq=bq, bk=bk, kv_len=s)
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True, kv_len=s)
        return flash_agreement(f"flash_attention {dtype} S {s} hd {hd}", got[:, :s],
                               want32[:, :s], tol)

    def model_layout(arch):
        """The kernel on (B, S, H, hd) q and (B, S, Hkv, hd) k/v; the plain
        version and SDPA get the expanded heads, made untimed."""
        heads, kv_heads, hd = FLASH_MODEL_SHAPES[arch]
        (q, k, v), flat, got, want32 = flash_model_case(torch, dev, gen, heads, kv_heads, hd)
        errs = flash_agreement(f"flash_attention bf16 at {arch}'s q {tuple(q.shape)} "
                               f"k/v {tuple(k.shape)}", got, want32, 2e-2)
        del got, want32
        s = LM_PROMPT
        q4, k4, v4 = (t.view(LM_BATCH, heads, s, hd) for t in flat)  # SDPA's (B, H, S, hd)
        flops = 2 * LM_BATCH * heads * s * s * hd  # causal: half of the two full products
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())  # KV heads read once
        bound_ms, bound_by = bound(flops, nbytes, BF16_FLOPS)
        ms = time_ms(torch, lambda: flash_attention_model(q, k, v, causal=True), 20)
        return {
            **errs, "ms": ms, "tflops": flops / ms * 1e-9,
            "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(*flat, causal=True), 5),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), 20),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }

    def wide(s=2048, heads=8, hd=512):
        """Past hd 256 (the SIMT wide kernel): q, k, v (1, s, heads, hd) bf16
        causal in the model layout, against the plain version and timed beside
        it and SDPA, with the SDPA backend the dispatcher picks."""
        q, k, v = (torch.randn((1, s, heads, hd), generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        flat = [t.permute(0, 2, 1, 3).reshape(heads, s, hd).contiguous() for t in (q, k, v)]
        got = flash_attention_model(q, k, v, causal=True).permute(0, 2, 1, 3).reshape(heads, s, hd)
        want32 = ref.flash_attention_ref(*(t.float() for t in flat), causal=True)
        errs = flash_agreement(f"flash_attention bf16 hd {hd}", got, want32, 2e-2)
        del got, want32
        q4, k4, v4 = (t.view(1, heads, s, hd) for t in flat)
        try:
            from torch.nn.attention import SDPBackend

            backend = SDPBackend(torch._fused_sdp_choice(q4, k4, v4, None, 0.0, True)).name
        except (AttributeError, TypeError, ValueError, RuntimeError) as e:
            backend = f"not known ({type(e).__name__})"
        bound_ms, bound_by = bound(2 * heads * s * s * hd, 2 * 4 * q.numel(), BF16_FLOPS)
        return {**errs, "shape": f"q, k, v (1, {s}, {heads}, {hd}) bf16 causal",
                "ms": time_ms(torch, lambda: flash_attention_model(q, k, v, causal=True), 5),
                "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(*flat, causal=True), 3),
                "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), 5),
                "sdpa_backend": backend, "bound_ms": bound_ms, "bound_by": bound_by}

    hd512 = wide()
    print(f"check flash_attention past hd 256: {hd512}", flush=True)
    flat32 = check_flat(torch.float32, 256, 128, 256, 1e-4)
    flat2k = check_flat(torch.bfloat16, 2048, 128, 1024, 2e-2)
    print(f"check flash_attention head-flattened: fp32 S 256 {flat32}, bf16 S 2048 {flat2k}",
          flush=True)
    hd112 = model_layout("zamba2-7b")
    print(f"check flash_attention at zamba2-7b's q (4, 1000, 32, 112) bf16: {hd112}", flush=True)
    row = {
        "shape": "q (4, 1000, 8, 256) bf16 causal, k/v (4, 1000, 1, 256): model layout, "
                 "native GQA",
        "tolerance": "bf16 rtol 2e-2, atol 2e-2 and each row's ||err|| / ||want|| within 1e-2 "
                     "of the fp32 plain output, at S 1000 (hd 256 over one KV head, hd 112) and "
                     "2048, and at hd 512 (S 2048, the wide kernel); fp32 1e-4 (rows 1e-4) at "
                     "S 256",
        "max_abs_err_bf16_s2048": flat2k["max_abs_err"],
        "row_rel_err_bf16_s2048": flat2k["row_rel_err"],
        "max_abs_err_fp32_s256": flat32["max_abs_err"],
        **model_layout("gemma-2b"),
        **{f"{k}_hd112": v for k, v in hd112.items()},
        **{f"{k}_hd512": v for k, v in hd512.items()},
    }
    print(f"check flash_attention at gemma-2b's q (4, 1000, 8, 256) bf16: "
          f"{ {k: v for k, v in row.items() if not k.endswith(('_hd112', '_hd512'))} }",
          flush=True)
    return row


SSM_SHAPE = (LM_BATCH, 1024, 112, 64, 64)  # zamba2-7b's (B, S padded to the chunk, H, P, N)


def ssm_inputs(torch, dev, gen, dtype, steps=SSM_SHAPE[1], shift=0.0):
    """u (B, steps, H, P) and head-shared b/c (B, steps, N) ~ N(0, 0.25) in
    ``dtype``; a_log (B, steps, H) fp32 = -softplus(N(shift, 1))."""
    import torch.nn.functional as F

    bsz, _, h, p, n = SSM_SHAPE
    a = -F.softplus(torch.randn((bsz, steps, h), generator=gen, device=dev) + shift)
    u = (torch.randn((bsz, steps, h, p), generator=gen, device=dev) * 0.5).to(dtype)
    b, c = ((torch.randn((bsz, steps, n), generator=gen, device=dev) * 0.5).to(dtype)
            for _ in range(2))
    return u, a, b, c


def ssm_fp16_state_inputs(torch, dev, gen):
    """fp16 inputs at SSM_SHAPE whose state passes fp16's 65,504 while y stays
    inside it: u ~ 100, B ~ 30, C ~ 1e-3 (each within 10 %) at a slow,
    constant decay of 0.01 a step (the state settles near 3e5, y near 2e4)."""
    bsz, s, h, p, n = SSM_SHAPE

    def around(v, shape):
        return (v * (1 + 0.1 * torch.randn(shape, generator=gen, device=dev))).half()

    u, b, c = around(100.0, (bsz, s, h, p)), around(30.0, (bsz, s, n)), around(1e-3, (bsz, s, n))
    return u, torch.full((bsz, s, h), -0.01, device=dev), b, c


def ssm_plain(scan, *args):
    """A plain scan of kernels.ref on the model layout's (u, a_log, b, c)."""
    from repro_torch.kernels import _util

    return _util.unflatten_heads(scan(*_util.flatten_ssm(*args[:4]), *args[4:]), args[0].shape[0])


def ssm_bf16_case(torch, dev, gen, chunk=256, shift=0.0) -> tuple:
    """The bf16 scan at zamba2-7b's shape, at the init's decay (``shift`` 0)
    or a slow one (-5): the inputs, the kernel's y, and the plain version's y
    in bf16 and in fp32 (on the same bf16 inputs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    u, a, b, c = ssm_inputs(torch, dev, gen, torch.bfloat16, shift=shift)
    got = ssm_scan_cuda(u, a, b, c, chunk=chunk)
    want = ssm_plain(ref.ssm_scan_chunked_ref, u, a, b, c, chunk)
    want32 = ssm_plain(ref.ssm_scan_chunked_ref, u.float(), a, b.float(), c.float(), chunk)
    return (u, a, b, c), got, want, want32


def ssm_flops(chunk: int) -> int:
    """The causal work of the scan at SSM_SHAPE: the (t, s <= t) pairs of the
    score and W u products, and the state's two products, per chunk."""
    bsz, s, h, p, n = SSM_SHAPE
    causal = chunk * (chunk + 1) // 2
    return bsz * h * (s // chunk) * (2 * causal * (n + p) + 4 * chunk * p * n)


def ssm_pass_checks(torch, u, a, b, c, chunk) -> dict:
    """The wgmma route's three passes at zamba2-7b's shape, each on its plain
    version's inputs: the chunk states within 1e-4 of their max (sdecay B
    enters as a hi + lo pair of bf16 values) and acum within 1e-5, the
    passed states within 1e-5 (the same fp32 recurrence), the outputs'
    rows within SSM_ROW_RTOL of the plain fp32 output; and each pass timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssd

    states, acum = ssd.ssd_chunk_states_cuda(u, a, b, chunk=chunk)
    want_states, want_acum = ref.ssd_chunk_states(u, a, b, chunk)
    errs = {"acum": check_close(f"ssm pass 1 acum, chunk {chunk}", acum, want_acum, 1e-5, 0.0),
            "states": check_close(f"ssm pass 1 states, chunk {chunk}", states, want_states,
                                  1e-4, 0.0)}
    entering = ssd.ssd_pass_states_cuda(want_states.clone(), want_acum, chunk=chunk)
    want_entering, _ = ref.ssd_pass_states(want_states, want_acum, chunk)
    errs["entering"] = check_close(f"ssm pass 2, chunk {chunk}", entering, want_entering,
                                   1e-5, 0.0)
    got = ssd.ssd_chunk_outputs_cuda(u, b, c, want_entering, want_acum, chunk=chunk)
    want = ref.ssd_chunk_outputs(u, b, c, want_entering, want_acum, chunk)
    errs["outputs_row_rel_err"] = check_rows(f"ssm pass 3, chunk {chunk}", got, want,
                                             SSM_ROW_RTOL)
    del want_states, want_entering, got, want
    spare = states.clone()  # pass 2 rewrites its input: time it on a copy
    return {"max_abs_err": errs, "ms": {
        "chunk_states": time_ms(torch, lambda: ssd.ssd_chunk_states_cuda(u, a, b, chunk=chunk),
                                10),
        "pass_states": time_ms(torch, lambda: ssd.ssd_pass_states_cuda(spare, acum, chunk=chunk),
                               10),
        "chunk_outputs": time_ms(torch, lambda: ssd.ssd_chunk_outputs_cuda(
            u, b, c, entering, acum, chunk=chunk), 10)}}


def ssm_checks(torch, dev, gen) -> dict:
    """ssm_scan at zamba2-7b's main-path shape: u (4, 1024, 112, 64) (S 1000
    padded to the chunk), a_log (4, 1024, 112) f32 at the init's decay
    (-softplus of a unit normal, ~0.8 a step), head-shared B/C (4, 1024, 64),
    chunk 256.  bf16 on the wgmma route: rtol/atol 2e-2 (one rounding of y)
    and each row's ||err|| / ||want|| within SSM_ROW_RTOL of the fp32 plain
    output, then the rows again at a slow decay (-softplus(N(-5, 1)), ~0.007
    a step, where the state passed between the 4 chunks and the key tiles far
    below the diagonal decide y; at the init's decay they add ~0) at chunks
    256 and 512 (the autotuner's pick) within SSM_SLOW_ROW_RTOL, and each
    pass against its plain version.  fp32 on the SIMT route (1e-4: sum
    order) against the chunked plain version at both decays, at chunk 512
    too, and at S 256 against the sequential recurrence.  fp16 on the SIMT
    route with a state past fp16's range and y inside it, against the fp32
    plain version (SSM_FP16_RTOL), and timed.  Tolerances but the row
    checks' are relative to max |y|."""
    from repro_torch.kernels import _util, ref
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    bsz, s, h, p, n = SSM_SHAPE
    chunk = 256
    _util.reset_launch_counts()
    ins = ssm_inputs(torch, dev, gen, torch.float32)
    err32 = check_close("ssm_scan fp32", ssm_scan_cuda(*ins, chunk=chunk),
                        ssm_plain(ref.ssm_scan_chunked_ref, *ins, chunk), 1e-4, 1e-4)
    ins = ssm_inputs(torch, dev, gen, torch.float32, shift=-5.0)
    err32_slow = check_close("ssm_scan fp32 at a slow decay", ssm_scan_cuda(*ins, chunk=chunk),
                             ssm_plain(ref.ssm_scan_chunked_ref, *ins, chunk), 1e-4, 1e-4)
    err32_512 = check_close("ssm_scan fp32 at a slow decay, chunk 512",
                            ssm_scan_cuda(*ins, chunk=512),
                            ssm_plain(ref.ssm_scan_chunked_ref, *ins, 512), 1e-4, 1e-4)
    ins = ssm_inputs(torch, dev, gen, torch.float32, 256)
    err_seq = check_close("ssm_scan fp32 S 256 vs the sequential recurrence",
                          ssm_scan_cuda(*ins, chunk=chunk), ssm_plain(ref.ssm_scan_ref, *ins),
                          1e-4, 1e-4)
    del ins
    slow = {}
    for ch in (256, 512):
        _, got, _, want32 = ssm_bf16_case(torch, dev, gen, ch, shift=-5.0)
        slow[ch] = {"row_rel_err": check_rows(f"ssm_scan bf16 at a slow decay, chunk {ch}",
                                              got, want32, SSM_SLOW_ROW_RTOL),
                    "row_rel_err_rounding": row_rel_err(want32.bfloat16(), want32)}
        del got, want32
    (u, a, b, c), got, want, want32 = ssm_bf16_case(torch, dev, gen, chunk)
    err = check_close("ssm_scan bf16", got.float(), want.float(), 2e-2, 2e-2)
    row_err = check_rows("ssm_scan bf16", got, want32, SSM_ROW_RTOL)
    row_rounding = row_rel_err(want32.bfloat16(), want32)
    del got, want, want32
    # fp16 keeps an fp32 state, as the reference does: the SIMT route
    ins16 = ssm_fp16_state_inputs(torch, dev, gen)
    want16 = ssm_plain(ref.ssm_scan_chunked_ref, *(t.float() for t in ins16), chunk)
    err16 = check_close("ssm_scan fp16 with its state past 65,504",
                        ssm_scan_cuda(*ins16, chunk=chunk).float(), want16, SSM_FP16_RTOL, 0.0)
    y16_max = float(want16.abs().max())
    del want16
    routes = _util.route_counts()["ssm_scan"]
    if routes != {"simt": 5, "wgmma": 3}:
        raise AssertionError(f"ssm_scan: routes {routes}; fp32 and fp16 on simt (5), bf16 on "
                             "wgmma (3)")
    passes = {ch: ssm_pass_checks(torch, u, a, b, c, ch) for ch in (chunk, 512)}
    print(f"check ssm_scan bf16 at a slow decay: {slow}; the wgmma route's passes (errors, "
          f"ms): {passes}", flush=True)
    flat = _util.flatten_ssm(u, a, b, c)  # the plain version's own layout, made untimed
    nbytes = 2 * u.numel() * u.element_size() + a.numel() * 4 + 2 * b.numel() * b.element_size()
    bound_ms, bound_by = bound(ssm_flops(chunk), nbytes, BF16_FLOPS)
    bound_512, bound_by_512 = bound(ssm_flops(512), nbytes, BF16_FLOPS)
    return {
        "shape": "u (4, 1024, 112, 64) bf16, a_log (4, 1024, 112) f32, b/c (4, 1024, 64) bf16, "
                 "chunk 256",
        "tolerance": f"bf16 rtol 2e-2, atol 2e-2 and each row's ||err|| / ||want|| within "
                     f"{SSM_ROW_RTOL} of the fp32 plain output; at a slow decay rows within "
                     f"{SSM_SLOW_ROW_RTOL} at chunks 256 and 512; fp32 1e-4 (also at a slow "
                     "decay, there at chunk 512 too, and at S 256 against the sequential "
                     f"recurrence); fp16 with its state past 65,504 (SIMT) {SSM_FP16_RTOL}; "
                     "but the row checks, relative to max |y|",
        "ssm_routes": {"bfloat16": "wgmma", "float32": "simt", "float16": "simt"},
        "max_abs_err": err, "row_rel_err": row_err, "row_rel_err_rounding": row_rounding,
        "row_rel_err_slow_decay": slow[256]["row_rel_err"],
        "row_rel_err_slow_decay_chunk512": slow[512]["row_rel_err"],
        "row_rel_err_rounding_slow_decay": slow[256]["row_rel_err_rounding"],
        "row_rel_err_rounding_slow_decay_chunk512": slow[512]["row_rel_err_rounding"],
        "max_abs_err_fp32": err32, "max_abs_err_fp32_slow_decay": err32_slow,
        "max_abs_err_fp32_chunk512": err32_512, "max_abs_err_fp32_sequential": err_seq,
        "ms": time_ms(torch, lambda: ssm_scan_cuda(u, a, b, c, chunk=chunk), 10),
        "ms_chunk512": time_ms(torch, lambda: ssm_scan_cuda(u, a, b, c, chunk=512), 10),
        "ms_passes": passes[chunk]["ms"], "ms_passes_chunk512": passes[512]["ms"],
        "max_abs_err_state_past_65504_fp16": err16, "max_abs_y_fp16": y16_max,
        "ms_fp16": time_ms(torch, lambda: ssm_scan_cuda(*ins16, chunk=chunk), 10),
        "plain_ms": time_ms(torch, lambda: ref.ssm_scan_chunked_ref(*flat, chunk), 3),
        "library_ms": None,  # no single PyTorch call computes this scan
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_ms_chunk512": bound_512, "bound_by_chunk512": bound_by_512,
        "bound_ms_fp32_pipes": ssm_flops(chunk) / FP32_FLOPS * 1e3,
    }


def op_latency_checks(torch, dev) -> dict:
    """op_latency: each op's chain of 8192 steps on 128 lanes against the same
    chain as PyTorch ops on the card (equal for the arithmetic ops, fma as one
    rounding; rtol = atol = 1e-6 for rsqrt, exp, tanh and log); the fma chain
    timed as one launch beside its eager chain (8192 launches)."""
    from repro_torch.kernels import op_latency as ops

    chain, width = 8192, 128
    errs = {}
    for name, (kind, *_consts) in ops.OPS.items():
        x0 = ops.chain_input(kind, width, dev)
        got, want = ops.op_chain(name, x0, chain), ops.op_chain_ref(name, x0, chain)
        if name.split(".")[0] in ("rsqrt", "exp", "tanh", "log"):
            errs[name] = check_close(f"op_latency {name}", got, want, 1e-6, 1e-6)
        elif not torch.equal(got, want):
            raise AssertionError(f"op_latency {name}: the chain differs from the PyTorch ops'")
        else:
            errs[name] = 0.0
    x0 = ops.chain_input("f32", width, dev)
    return {
        "shape": f"fma.f32 chain of {chain} on {width} lanes", "max_abs_err": max(errs.values()),
        "tolerance": "equal for move/add/mul/fma/max and the s32 ops; rsqrt, exp, tanh, log "
                     "rtol = atol = 1e-6",
        "ms": time_ms(torch, lambda: ops.op_chain("fma.f32", x0, chain), 20),
        "plain_ms": time_ms(torch, lambda: ops.op_chain_ref("fma.f32", x0, chain), 1, warmup=1),
        "library_ms": None,  # no PyTorch call runs a dependent chain
        # the contract's floor: chain x width FMAs at the FP32 pipes' rate and
        # the lanes in and out; the chain's latency is what the probe measures
        "bound_ms": max(2 * chain * width / FP32_FLOPS, 2 * width * 4 / HBM_BPS) * 1e3,
        "bound_by": "operations",
    }


def main_path(torch, dev) -> tuple:
    """Phase 4: ``bench run dissect --full`` through the CLI function.  Returns
    the launch counts, the seconds and the op-latency table (ns per op)."""
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
    for probe in ("pointer_chase", "stream_bandwidth", "matmul_throughput", "op_latency"):
        backend = rep.probe_results[probe]["meta"]["backend"]
        if backend != "cuda":
            raise AssertionError(f"{probe} ran on backend {backend!r}, not the cuda kernels")
    for k in ("pchase", "stream_reduce", "matmul", "op_latency"):
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
    print(f"op_latency ns/op (one launch of the op_latency kernel a chain of "
          f"{ops['meta']['chain']}, less the move-only chain's {ops['meta']['base_ns']} ns a "
          f"step): " + ", ".join(f"{x}:{y}" for x, y in zip(ops["x"], ops["y"])), flush=True)
    slow = {x: y for x, y in zip(ops["x"], ops["y"])
            if x in ("add.f32", "mul.f32", "fma.f32") and not 0 <= y < 10}
    if slow:
        raise AssertionError(f"op_latency: fp32 add/mul/fma take 10 ns or more a step: {slow}")
    print(f"fitted levels (latency ns, capacity bytes): {rep.detected_levels}")
    print(f"fitted stream {fitted.main_memory_Bps / 1e9} GB/s, "
          f"fp32 {fitted.peak('float32') / 1e9} GFLOP/s", flush=True)
    cmp = hw.compare("measured-host", "h100")
    print("compare(measured-host, h100): " + json.dumps(
        {k: cmp[k] for k in ("peak_ratio", "main_memory_Bps_ratio", "levels")}), flush=True)
    return counts, seconds, dict(zip(ops["x"], ops["y"])), rep.detected_levels


def gemm_path(torch, dev) -> dict:
    """Phase 4b: the Tab 4.3 ladder, ``bench run gemm_lp[cuda] gemm_lp[torch]
    gemm[cuda] --full`` through the CLI function, with the launch counts
    zeroed before and read after.  Every record of the reference's full grid
    must be there (no error, no skipped point), every matmul instance must
    have launched, and the measured ladder at the top size is printed beside
    the H100 datasheet's."""
    from repro_torch.bench import cli
    from repro_torch.kernels import _util

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gemm.json")
        t0 = time.perf_counter()
        _util.reset_launch_counts()
        rc = cli.main(["run", "gemm_lp[cuda]", "gemm_lp[torch]", "gemm[cuda]", "--full",
                       "--out", out])
        counts = _util.launch_counts()
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"bench run gemm_lp / gemm --full exited {rc}")
        with open(out) as f:
            result = json.load(f)
    print(f"gemm_lp[cuda], gemm_lp[torch], gemm[cuda] --full: {seconds:.1f} s; launches {counts}",
          flush=True)
    if result["errors"] or result["env"]["device_kind"] != torch.cuda.get_device_name(dev):
        raise AssertionError(f"gemm suites: errors {result['errors']}, env {result['env']}")
    recs = {r["name"]: r["value"] for r in result["records"]}
    dtypes = ("float32", "bfloat16", "float16", "int8", "float8_e4m3fn")
    sizes = (256, 512, 1024)
    want = {f"gemm_lp_{dt}:{n}[{be}]" for dt in dtypes for n in sizes for be in ("cuda", "torch")}
    want |= {f"gemm_dispatch_float32:{n}[cuda]" for n in sizes}
    missing = want - set(recs)
    skipped = [k for k in recs if "skipped" in k]
    if missing or skipped or not all(math.isfinite(v) and v > 0 for v in recs.values()):
        raise AssertionError(f"gemm suites: missing {sorted(missing)}, skipped {skipped}")
    for k in ("matmul", *MATMUL_LP, "matmul_transpose"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{k} kernel was not launched by the gemm suites")
    top = max(sizes)
    ladder = {}
    for hi, lo, sheet in (("float16", "float32", BF16_FLOPS / FP32_FLOPS),
                          ("int8", "float16", FP8_FLOPS / BF16_FLOPS),
                          ("float8_e4m3fn", "bfloat16", FP8_FLOPS / BF16_FLOPS)):
        for be in ("cuda", "torch"):
            ladder[f"{hi}/{lo}[{be}]"] = (recs[f"gemm_lp_{hi}:{top}[{be}]"]
                                          / recs[f"gemm_lp_{lo}:{top}[{be}]"])
        ladder[f"{hi}/{lo}[datasheet]"] = sheet
    print(f"gemm_lp measured ladder at n={top}: {json.dumps(ladder)}", flush=True)
    print("gemm_lp GFLOP/s: " + json.dumps(
        {k: v for k, v in recs.items() if k.startswith(("gemm_lp_", "gemm_dispatch_"))
         and ":" in k}), flush=True)
    return counts


def suites_path(torch, dev, tab41: dict, levels) -> dict:
    """Phase 4c: the paper's other tables, ``bench run instr bandwidth axpy
    memhier scheduler atomics throttle --full`` through the CLI function with
    every variant, the launch counts zeroed before and read after, and each
    registered benchmark's own launches read around its run: each must
    launch exactly its kernels of SUITE_KERNELS (the [torch] variants none),
    and no record may error or be skipped.  Prints Tab 4.1 beside phase 4's,
    the memhier levels, stream GB/s per footprint, the atomics rates and the
    scheduler ratios; walks the pointer chase past the L2 (HBM_WALK_*) beside
    phase 4's L2 plateau; then gates a ``--quick`` run of every ported suite
    against benchmarks/baselines_torch (must PASS) and the same result with
    GATE_PROBE doubled (must FAIL)."""
    from repro_torch.bench import cli
    from repro_torch.core import probes, registry
    from repro_torch.kernels import _util

    per_suite, run = {}, registry.BenchSpec.run

    def counted(spec, *args, **kw):
        before = _util.launch_counts()
        try:
            return run(spec, *args, **kw)
        finally:
            after = _util.launch_counts()
            per_suite[spec.name] = {k for k in after if after[k] != before.get(k, 0)}

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "suites.json")
        t0 = time.perf_counter()
        registry.BenchSpec.run = counted
        try:
            _util.reset_launch_counts()
            rc = cli.main(["run", *PAPER_SUITES, "--full", "--out", out])
            counts = _util.launch_counts()
        finally:
            registry.BenchSpec.run = run
        seconds = time.perf_counter() - t0
        with open(out) as f:
            result = json.load(f)
        print(f"{' '.join(PAPER_SUITES)} --full: {seconds:.1f} s; launches {counts}; per "
              f"benchmark {json.dumps({k: sorted(v) for k, v in per_suite.items()})}", flush=True)
        if rc != 0 or result["errors"]:
            raise RuntimeError(f"bench run {' '.join(PAPER_SUITES)} --full exited {rc}: "
                               f"{result['errors']}")
        wrong = {k: sorted(v) for k, v in per_suite.items() if v != SUITE_KERNELS.get(k, set())}
        if wrong or set(per_suite) < set(SUITE_KERNELS):
            raise AssertionError(f"suites launched other kernels than {SUITE_KERNELS}: {wrong}")
        recs = {r["name"]: r for r in result["records"]}
        bad = [k for k, r in recs.items() if "skipped" in k or not math.isfinite(r["value"])]
        if bad or result["env"]["device_kind"] != torch.cuda.get_device_name(dev):
            raise AssertionError(f"suites: skipped or not finite {bad}, env {result['env']}")

        def table(prefix, key=lambda r: r["value"]):
            """The measured records under ``prefix`` (the reference's modeled
            TPU rows are not the card's), keyed by the rest of the name."""
            return {k[len(prefix):]: key(r) for k, r in recs.items()
                    if k.startswith(prefix) and r["measured"] and "_tpu_" not in k}

        tab = table("oplat_")
        print("Tab 4.1, ns per dependent op (instr --full, phase 4 in brackets): " + ", ".join(
            f"{k}: {v:.4g} [{tab41[k]:.4g}]" if k in tab41 else f"{k}: {v:.4g}"
            for k, v in tab.items()), flush=True)
        print("memhier levels (latency ns, capacity bytes): " + json.dumps(
            table("pchase_host_level", lambda r: (r["value"], r["metrics"]["capacity_bytes"]))))
        print("pchase ns/load by footprint: " + json.dumps(
            {k: v for k, v in table("pchase_host_").items() if k.endswith("KiB")}
            | {"dispatch": table("pchase_dispatch_")}))
        print("stream GB/s by footprint: " + json.dumps(table("streambw_host_")))
        print("stream GB/s through the dispatch API: " + json.dumps(table("streambw_dispatch_")))
        print("axpy GB/s: " + json.dumps(table("axpy_")))
        print("atomics Mupdates/s by collisions: " + json.dumps(table("scatter_contention_")))
        print("scheduler ratio to one unit: " + json.dumps(
            table("grid_occupancy_", lambda r: r["metrics"]["ratio_vs_1program"])), flush=True)

        _util.reset_launch_counts()
        walk = probes.probe_pointer_chase(HBM_WALK_BYTES, steps=HBM_WALK_STEPS, device=dev)
        add_counts(counts, _util.launch_counts())
        l2 = max(lat for lat, _ in levels) if levels else float("nan")
        print(f"pointer chase past the L2, {HBM_WALK_STEPS} steps, ns/load: " + json.dumps(
            dict(zip(walk.x, walk.y))) + f"; phase 4's slowest plateau {l2:.4g} ns", flush=True)
        if walk.meta["backend"] != "cuda" or not all(math.isfinite(y) and y > 0 for y in walk.y):
            raise AssertionError(f"HBM walk: {walk}")

        quick = os.path.join(tmp, "quick.json")
        t0 = time.perf_counter()
        if cli.main(["run", *PORTED_SUITES, "--quick", "--out", quick]) != 0:
            raise RuntimeError("bench run --quick of the ported suites failed")
        gate = cli.main(["compare", quick, BASELINES])
        with open(quick) as f:
            doubled = json.load(f)
        (probe,) = [r for r in doubled["records"] if r["name"] == GATE_PROBE]
        probe["value"] *= 2
        with open(quick, "w") as f:
            json.dump(doubled, f)
        gate_doubled = cli.main(["compare", quick, BASELINES])
        print(f"gate: --quick run and compare in {time.perf_counter() - t0:.1f} s; against "
              f"{os.path.relpath(BASELINES, ROOT)} exit {gate} (0 = PASS), with {GATE_PROBE} "
              f"doubled exit {gate_doubled} (1 = FAIL)", flush=True)
        if gate != 0 or gate_doubled != 1:
            raise AssertionError(f"gate: compare exited {gate}, doubled {gate_doubled}")
    return counts


def axpy_path(torch, dev) -> tuple:
    """Phase 5: the Ch. 1 experiment as the probe runs it, then Fig 1.1's
    access-width sweep at an array far past the 50 MB L2, each width counted
    the same way.  Returns the probe's launch counts and, by width, the
    sweep's GB/s and launches."""
    from repro_torch.core import probes
    from repro_torch.kernels import _util

    _util.reset_launch_counts()
    res = probes.probe_block_shape_bandwidth(device=dev)
    counts = _util.launch_counts()
    if res.meta["backend"] != "cuda" or counts.get("axpy", 0) <= 0:
        raise AssertionError(f"block-shape probe bypassed the axpy kernel: {res.meta} {counts}")
    print("block_shape_bandwidth GB/s by tile width (1 MiB arrays): "
          + ", ".join(f"{x}:{y:.1f}" for x, y in zip(res.x, res.y)) + f"; launches {counts}")
    sweep = {}
    for vb in (4, 8, 16):
        _util.reset_launch_counts()
        big = probes.probe_block_shape_bandwidth(
            footprint=256 << 20, col_widths=(2048,), device=dev, vec_bytes=vb)
        launches = _util.launch_counts().get("axpy", 0)
        if launches <= 0:
            raise AssertionError(f"the {vb}-byte sweep bypassed the axpy kernel")
        sweep[vb] = {"probe_gbps": big.y[0], "launches": launches}
        print(f"access width {vb * 8}-bit, 256 MiB arrays: {big.y[0]:.1f} GB/s; "
              f"launches {launches}", flush=True)
    return counts, sweep


def entry_point_path(torch, dev) -> dict:
    """Phase 6: the kernel layer's bandwidth entry points, as a user calls them."""
    from repro_torch.kernels import _util
    from repro_torch.kernels import api

    rows, cols = 4096, 512  # 8 MiB of ones: every partial sum stays below 2^24, so exact
    x = torch.ones((rows, cols), device=dev)
    _util.reset_launch_counts()
    out = api.stream_copy(x)
    sums = {s: float(api.strided_reduce(x, stride=s)[0, 0]) for s in (1, 2, 3, 128)}
    torch.cuda.synchronize()
    counts = _util.launch_counts()
    want = {s: float(rows // 64 * -(-64 // s) * cols) for s in sums}  # ones: a count of elements
    if not torch.equal(out, x) or sums != want:
        raise AssertionError(f"entry points: strided sums {sums}, expected {want}")
    for k in ("stream_copy", "strided_reduce"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{k} kernel was not launched through kernels.api")
    print(f"entry points api.stream_copy / api.strided_reduce: launches {counts}", flush=True)
    return counts


def lm_path(torch, dev) -> dict:
    """Phase 7: gemma-2b, full width and depth, through build_model's entry
    points with the flash kernel; the plain blockwise path is the reference."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _util
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params

    cfg = get_config("gemma-2b").replace(attn_impl="pallas")
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(f"lm: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} params "
          f"({params['embed'].dtype}), init {time.perf_counter() - t0:.1f} s", flush=True)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    long_prompt = torch.randint(0, cfg.vocab_size, (1, LM_LONG), generator=gen, device=dev)

    def serve(m):
        """prefill, greedy decode, long prefill; wall times after a synchronize."""
        out = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = m.prefill(params, {"tokens": prompts}, LM_PROMPT + LM_STEPS)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["last"] = last.float()
        tok, toks = last.argmax(-1), []
        t0 = time.perf_counter()
        for i in range(LM_STEPS):
            pos = torch.full((LM_BATCH,), LM_PROMPT + i, dtype=torch.int32, device=dev)
            logits, cache = m.decode_step(params, cache, tok, pos)
            tok = logits.argmax(-1)
            toks.append(tok)
        torch.cuda.synchronize()
        out["decode_s"] = time.perf_counter() - t0
        out["tokens"] = torch.stack(toks, 1)
        out["decode_logits"] = logits.float()
        t0 = time.perf_counter()
        out["long_last"] = m.prefill(params, {"tokens": long_prompt})[0].float()
        torch.cuda.synchronize()
        out["long_prefill_s"] = time.perf_counter() - t0
        return out

    plain_model = build_model(cfg.replace(attn_impl="blockwise"), device=dev)
    with torch.inference_mode():
        model.prefill(params, {"tokens": prompts[:1, :64]})  # warm-up: cuBLAS, kernel attributes
        _util.reset_launch_counts()
        run = serve(model)
        counts = _util.launch_counts()
        plain = serve(plain_model)
        roof = roofline_share(f"{cfg.name} prefill {LM_BATCH} x {LM_PROMPT} (plain path counted)",
                              plain_model.prefill,
                              (params, {"tokens": prompts}, LM_PROMPT + LM_STEPS), n_params,
                              LM_BATCH * LM_PROMPT, run["prefill_s"])
    if counts != {"flash_attention": 2 * cfg.n_layers}:
        raise AssertionError(f"lm: launches {counts}, expected flash_attention "
                             f"{cfg.n_layers} per prefill, 2 prefills")
    for key, shape in (("last", (LM_BATCH, cfg.padded_vocab)), ("long_last", (1, cfg.padded_vocab)),
                       ("tokens", (LM_BATCH, LM_STEPS))):
        if run[key].shape != shape:
            raise AssertionError(f"lm: {key} has shape {tuple(run[key].shape)}, expected {shape}")
    for key in ("last", "long_last", "decode_logits"):
        if not torch.isfinite(run[key]).all():
            raise AssertionError(f"lm: {key} is not finite")
    rel = {k: float((run[k] - plain[k]).abs().max() / plain[k].abs().max())
           for k in ("last", "long_last")}
    same = float((run["tokens"] == plain["tokens"]).float().mean())
    first_same = float((run["tokens"][:, 0] == plain["tokens"][:, 0]).float().mean())
    res = {
        "prefill_s": run["prefill_s"], "plain_prefill_s": plain["prefill_s"],
        "prefill_tok_s": LM_BATCH * LM_PROMPT / run["prefill_s"],
        "decode_s": run["decode_s"], "plain_decode_s": plain["decode_s"],
        "decode_tok_s": LM_BATCH * LM_STEPS / run["decode_s"],
        "long_prefill_s": run["long_prefill_s"], "plain_long_prefill_s": plain["long_prefill_s"],
        "long_prefill_tok_s": LM_LONG / run["long_prefill_s"],
        "rel_err_last_logits": rel["last"], "rel_err_long_last_logits": rel["long_last"],
        "greedy_equal_share": same, "first_greedy_equal_share": first_same,
        "launches": counts, "prefill_bound_share": roof["bound_share_of_kernel_path"],
    }
    print("lm: " + json.dumps(res), flush=True)
    if max(rel.values()) > 0.1:
        raise AssertionError(f"lm: last logits differ from the plain path by {rel} of their max")
    return counts


def zamba_path(torch, dev) -> dict:
    """Phase 8: zamba2-7b, full width and depth, through build_model's entry
    points with the ssm_scan and flash kernels; the plain path (ssm_impl
    "xla", attn_impl "blockwise") is the reference.  Per path: loss_fn on 4
    sequences of 1000 tokens, the forward's logits, prefill of all but the
    last token (cache 1016), then 16 decode steps, the first fed the last
    prompt token (so its logits continue the forward), the rest greedy.
    Launches are zeroed before and read after each call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _util
    from repro_torch.models import build_model, mamba
    from repro_torch.models.common import count_params

    phase_start = time.perf_counter()
    cfg = get_config("zamba2-7b").replace(ssm_impl="pallas", attn_impl="pallas")
    plain_cfg = cfg.replace(ssm_impl="xla", attn_impl="blockwise")
    n_super, per, tail = mamba._zamba_counts(cfg)
    n_attn = n_super + (1 if tail else 0)
    model, plain_model = build_model(cfg, device=dev), build_model(plain_cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    print(f"zamba: {cfg.name}, {cfg.n_layers} Mamba2 layers, {n_attn} shared-attention calls, "
          f"d_model {cfg.d_model}, {count_params(params)} params ({params['embed'].dtype}), "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    seq = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1), generator=gen, device=dev)
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    prompts = batch["tokens"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    routes = {}

    def run(m, c):
        out, counts = {}, {}

        def call(key, fn):
            _util.reset_launch_counts()
            res, out[f"{key}_s"] = timed(fn)
            counts[key] = _util.launch_counts()
            routes[key] = _util.route_counts()
            return res

        out["loss"] = float(call("loss_fn", lambda: m.loss_fn(params, batch)))
        logits = call("forward", lambda: mamba.zamba_forward(params, prompts, c))
        out["last"], out["second_last"] = logits[:, -1].float(), logits[:, -2].float()
        del logits
        last, cache = call("prefill", lambda: m.prefill(params, {"tokens": prompts[:, :-1]},
                                                        LM_PROMPT + ZAMBA_STEPS))
        out["prefill_last"] = last.float()

        def decode():
            nonlocal cache
            tok, toks = prompts[:, -1], []
            for i in range(ZAMBA_STEPS):
                pos = torch.full((LM_BATCH,), LM_PROMPT - 1 + i, dtype=torch.int32, device=dev)
                logits, cache = m.decode_step(params, cache, tok, pos)
                if i == 0:
                    out["first_step"] = logits.float()
                tok = logits.argmax(-1)
                toks.append(tok)
            return torch.stack(toks, 1)

        out["tokens"] = call("decode", decode)
        return out, counts

    def autotuned():
        """The forward and the loss under kernel_policy(autotune=True), at the
        chunk the autotuner picks for the kernel's operands on the H100.  The
        model hands the op cfg.ssm_chunk explicitly, and an explicit kwarg wins
        over autotune in both packages, so the config carries the pick; a spy
        on the kernel's wrapper records the chunk each launch ran at."""
        from repro_torch.core.autotune import choose_ssm_chunk, dtype_name
        from repro_torch.kernels import ssm_scan as ssd
        from repro_torch.kernels.api import kernel_policy

        seen, kernel = [], ssd.ssm_scan_cuda

        def spy(u, a_log, b, c, *, chunk):
            seen.append((u.dtype, chunk))
            return kernel(u, a_log, b, c, chunk=chunk)

        ssd.ssm_scan_cuda = spy
        try:
            mamba.zamba_forward(params, prompts[:1, :8], cfg)  # the kernel's operand dtype
            chunk = choose_ssm_chunk(LM_PROMPT, cfg.ssm_head_dim, cfg.ssm_state,
                                     dtype_name(seen[0][0]), hw="nvidia-h100-sxm")
            seen.clear()
            acfg = cfg.replace(ssm_chunk=chunk)
            with kernel_policy(autotune=True):
                _util.reset_launch_counts()
                logits, seconds = timed(lambda: mamba.zamba_forward(params, prompts, acfg))
                launches = _util.launch_counts()
                routes["autotuned_forward"] = _util.route_counts()
                loss = float(build_model(acfg, device=dev).loss_fn(params, batch))
        finally:
            ssd.ssm_scan_cuda = kernel
        chunks = sorted({c for _, c in seen})
        return {"chunk": chunk, "kernel_chunks": chunks, "forward_s": seconds,
                "launches": launches, "loss": loss, "last": logits[:, -1].float()}

    with torch.inference_mode():
        # warm-up: cuBLAS handles and the kernels' shared-memory attributes
        model.loss_fn(params, {"tokens": seq[:1, :32], "targets": seq[:1, 1:33]})
        run_out, counts = run(model, cfg)
        kernel_routes = dict(routes)
        plain, plain_counts = run(plain_model, plain_cfg)
        roof = roofline_share(f"{cfg.name} forward {LM_BATCH} x {LM_PROMPT} (plain path counted)",
                              mamba.zamba_forward, (params, prompts, plain_cfg),
                              count_params(params), LM_BATCH * LM_PROMPT, run_out["forward_s"])
        auto = autotuned()
    want_routes = {"ssm_scan": {"wgmma": cfg.n_layers}}
    for key in ("loss_fn", "forward"):
        if kernel_routes[key] != want_routes:
            raise AssertionError(f"zamba {key}: ssm_scan routes {kernel_routes[key]}, "
                                 f"expected {want_routes}")
    if routes["autotuned_forward"] != want_routes:
        raise AssertionError(f"zamba autotuned: ssm_scan routes {routes['autotuned_forward']}")
    want = {"loss_fn": {"ssm_scan": cfg.n_layers, "flash_attention": n_attn},
            "forward": {"ssm_scan": cfg.n_layers, "flash_attention": n_attn},
            "prefill": {"flash_attention": n_attn}, "decode": {}}
    if counts != want:
        raise AssertionError(f"zamba: launches {counts}, expected {want}")
    if any(plain_counts.values()):
        raise AssertionError(f"zamba: the plain path launched kernels: {plain_counts}")
    for key in ("last", "second_last", "prefill_last", "first_step"):
        got = run_out[key]
        if got.shape != (LM_BATCH, cfg.padded_vocab) or not torch.isfinite(got).all():
            raise AssertionError(f"zamba: {key} is not finite of shape (4, {cfg.padded_vocab})")
    if run_out["tokens"].shape != (LM_BATCH, ZAMBA_STEPS) or not math.isfinite(run_out["loss"]):
        raise AssertionError("zamba: tokens or loss malformed")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    agree = {
        "loss_vs_plain": abs(run_out["loss"] - plain["loss"]) / abs(plain["loss"]),
        "last_logits_vs_plain": rel(run_out["last"], plain["last"]),
        "prefill_vs_forward_pos_-2": rel(run_out["prefill_last"], run_out["second_last"]),
        "first_step_vs_forward_pos_-1": rel(run_out["first_step"], run_out["last"]),
        "plain_prefill_vs_plain_forward_pos_-2": rel(plain["prefill_last"], plain["second_last"]),
    }
    res = {
        **{k: run_out[k] for k in ("loss_fn_s", "forward_s", "prefill_s", "decode_s", "loss")},
        **{f"plain_{k}": plain[k] for k in ("loss_fn_s", "forward_s", "prefill_s", "decode_s",
                                             "loss")},
        "forward_tok_s": LM_BATCH * LM_PROMPT / run_out["forward_s"],
        "decode_ms_per_step": run_out["decode_s"] / ZAMBA_STEPS * 1e3,
        "decode_tok_s": LM_BATCH * ZAMBA_STEPS / run_out["decode_s"],
        "greedy_equal_share": float((run_out["tokens"] == plain["tokens"]).float().mean()),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        **agree, "launches": counts, "ssm_routes": kernel_routes["forward"],
        "forward_bound_share": roof["bound_share_of_kernel_path"],
        "phase_s": time.perf_counter() - phase_start,
    }
    print("zamba: " + json.dumps(res), flush=True)
    if max(agree.values()) > 0.1:
        raise AssertionError(f"zamba: outputs disagree by more than 0.1 of their max: {agree}")
    # with random weights the loss sits near ln(vocab) whatever the layers compute,
    # so 0.1 cannot catch a wrong layer; the kernels' own rounding is ~2e-5
    if agree["loss_vs_plain"] > LOSS_RTOL:
        raise AssertionError(f"zamba: loss differs from the plain path's by "
                             f"{agree['loss_vs_plain']} relative, over {LOSS_RTOL}")
    auto_agree = {"loss_vs_chunk256": abs(auto["loss"] - run_out["loss"]) / abs(run_out["loss"]),
                  "last_logits_vs_chunk256": rel(auto["last"], run_out["last"])}
    print("zamba autotuned: " + json.dumps(
        {k: v for k, v in auto.items() if k != "last"} | auto_agree), flush=True)
    if auto["chunk"] != 512 or auto["kernel_chunks"] != [512]:
        raise AssertionError(f"zamba autotuned: chunk {auto['chunk']}, the kernel ran at "
                             f"{auto['kernel_chunks']}; 512 expected")
    if auto["launches"] != want["forward"]:
        raise AssertionError(f"zamba autotuned: launches {auto['launches']}")
    if auto_agree["last_logits_vs_chunk256"] > 0.1 or auto_agree["loss_vs_chunk256"] > LOSS_RTOL:
        raise AssertionError(f"zamba autotuned: disagrees with the chunk-256 run: {auto_agree}")
    counts["autotuned_forward"] = auto["launches"]
    total = {}
    for c in counts.values():
        add_counts(total, c)
    return total


def roofline_share(name, fn, args, n_params, tokens, measured_s) -> dict:
    """Count ``fn(*args)`` once, untimed (``perfmodel.extract_costs``: ATen
    FLOPs and bytes, so on the plain path, whose ops it sees), roofline it
    against the H100 SXM at bf16 on one card, and divide the bound into the
    kernel path's measured time."""
    from repro_torch.perfmodel import CollectiveStats, extract_costs, roofline

    costs = extract_costs(fn, *args)
    terms = roofline(costs, CollectiveStats(), chips=1, kind="infer", n_params_active=n_params,
                     tokens=tokens, hw="nvidia-h100-sxm", dtype="bfloat16")
    bound_s = max(terms.compute_s, terms.memory_s, terms.collective_s)
    res = {"flops": costs.flops_per_device, "bytes": costs.bytes_per_device,
           "compute_s": terms.compute_s, "memory_s": terms.memory_s,
           "collective_s": terms.collective_s, "dominant": terms.dominant,
           "model_flops": terms.model_flops, "roofline_fraction": terms.roofline_fraction,
           "kernel_path_s": measured_s, "bound_share_of_kernel_path": bound_s / measured_s}
    print(f"roofline {name}: {json.dumps(res)}", flush=True)
    if not (bound_s > 0 and math.isfinite(res["bound_share_of_kernel_path"])):
        raise AssertionError(f"roofline {name}: {res}")
    return res


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def main() -> int:
    import torch

    start = time.perf_counter()
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
    torch.cuda.empty_cache()
    counts, _, rows["op_latency"]["ns_per_op"], levels = main_path(torch, dev)
    add_counts(counts, gemm_path(torch, dev))
    add_counts(counts, suites_path(torch, dev, rows["op_latency"]["ns_per_op"], levels))
    probe_counts, sweep = axpy_path(torch, dev)
    add_counts(counts, probe_counts)
    for r in rows["axpy"]["sweep_256mib"]:
        r.update(sweep[r["vec_bytes"]])
    add_counts(counts, entry_point_path(torch, dev))
    torch.cuda.empty_cache()
    add_counts(counts, lm_path(torch, dev))
    torch.cuda.empty_cache()  # gemma's params are gone; zamba2's 27 GB come next
    add_counts(counts, zamba_path(torch, dev))

    print(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} s", flush=True)
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
        entry.update({k: v for k, v in r.items()
                      if k in ("latency_bound_ms", "tflops", "row_rel_err", "sweep_256mib",
                               "transpose_ms", "ns_per_op", "ssm_routes", "ms_passes")
                      or k.endswith(("_hd112", "_hd512", "_4096", "_chunk512", "_fp16"))})
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
