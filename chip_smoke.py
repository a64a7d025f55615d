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
   same way, and the access-width sweep of Fig 1.1 at an HBM-sized array,
   each width counted on its own (phase 3 times the same sweep beside
   ``torch.add``; the kernels line carries both as axpy's ``sweep_256mib``);
6. the kernel layer's bandwidth entry points ``api.stream_copy`` and
   ``api.strided_reduce`` on 8 MiB of ones (exact sums), counted the same way;
7. the dense LM at gemma-2b's full width and depth, ``attn_impl="pallas"``,
   through ``build_model(cfg).prefill`` / ``decode_step``: 4 prompts of 1000
   tokens, 32 greedy steps, then one prompt of 2048; flash_attention must
   launch once per layer per prefill; the same requests through the plain
   ``attn_impl="blockwise"`` path are the reference;
8. the Zamba2 hybrid LM at zamba2-7b's full width and depth (81 Mamba2
   layers, 14 shared-attention calls at hd 112), ``ssm_impl="pallas"`` and
   ``attn_impl="pallas"``, through ``build_model(cfg).loss_fn`` (81 ssm_scan
   and 14 flash_attention launches), ``prefill`` (14 flash_attention) and
   16 ``decode_step``s on 4 sequences of 1000 tokens; the same requests
   through the plain path (``ssm_impl="xla"``, ``attn_impl="blockwise"``)
   are the reference;
9. a ``kernels`` line, one JSON line of per-kernel numbers, and the final
   ``{"ok": true, "device": ...}`` line.

Rates used for the bounds (NVIDIA H100 SXM data sheet): 3.35 TB/s HBM,
67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16 dense on them.
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
KERNELS = ("pchase", "stream_copy", "stream_reduce", "strided_reduce", "axpy", "matmul",
           "flash_attention", "ssm_scan")
SOURCES = {
    "pchase": ("src/repro_torch/kernels/csrc/pchase.cu", "src/repro/kernels/pchase.py:22"),
    "stream_copy": ("src/repro_torch/kernels/csrc/membw.cu", "src/repro/kernels/membw.py:19"),
    "stream_reduce": ("src/repro_torch/kernels/csrc/membw.cu", "src/repro/kernels/membw.py:39"),
    "strided_reduce": ("src/repro_torch/kernels/csrc/membw.cu", "src/repro/kernels/membw.py:67"),
    "axpy": ("src/repro_torch/kernels/csrc/axpy.cu", "src/repro/kernels/axpy.py:16"),
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:58"),
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
FLASH_MODEL_SHAPES = {"gemma-2b": (8, 1, 256), "zamba2-7b": (32, 32, 112)}  # H, Hkv, hd
MEMBW_SHAPE = (65536, 512)  # 128 MiB of fp32: the probes' largest footprint
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
    from repro_torch.core.pchase import single_cycle_permutation
    from repro_torch.kernels import ref
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

    rows["axpy"] = axpy_checks(torch, dev, gen)

    # matmul: the largest full-mode size, fp32 with no TF32 anywhere; bf16 beside
    # torch.matmul bf16 records the gap the gemm_lp slice's tensor-core path closes
    torch.backends.cuda.matmul.allow_tf32 = False
    nn = 2048
    a = torch.randn((nn, nn), generator=gen, device=dev) * 0.3
    b = torch.randn((nn, nn), generator=gen, device=dev) * 0.3
    err = check_close("matmul", matmul_cuda(a, b), ref.matmul_ref(a, b), 1e-4, 1e-4)
    ab, bb = a.bfloat16(), b.bfloat16()
    err_bf16 = check_close("matmul bf16", matmul_cuda(ab, bb), ref.matmul_ref(ab, bb), 3e-2, 3e-2)
    rows["matmul"] = {
        "shape": "(2048, 2048) @ (2048, 2048) float32", "tolerance": "rtol 1e-4, atol 1e-4",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: matmul_cuda(a, b), 10),
        "plain_ms": time_ms(torch, lambda: ref.matmul_ref(a, b), 10),
        "library_ms": time_ms(torch, lambda: torch.matmul(a, b), 10),
        "bound_ms": max(2 * nn**3 / FP32_FLOPS, 3 * nn * nn * 4 / HBM_BPS) * 1e3,
        "bound_by": "operations",
        "max_abs_err_bf16": err_bf16,
        "ms_bf16": time_ms(torch, lambda: matmul_cuda(ab, bb), 10),
        "plain_ms_bf16": time_ms(torch, lambda: ref.matmul_ref(ab, bb), 10),
        "library_ms_bf16": time_ms(torch, lambda: torch.matmul(ab, bb), 10),
        "bound_ms_bf16": max(2 * nn**3 / BF16_FLOPS, 3 * nn * nn * 2 / HBM_BPS) * 1e3,
    }
    print(f"check matmul bf16 2048^3 (FP32 pipes; torch.matmul bf16 on the tensor cores): "
          f"{ {k: v for k, v in rows['matmul'].items() if k.endswith('_bf16')} }", flush=True)
    del a, b, ab, bb
    rows["stream_copy"] = copy_checks(torch, dev, gen)
    rows["strided_reduce"] = strided_checks(torch, dev, gen)
    rows["flash_attention"] = flash_checks(torch, dev, gen)
    rows["ssm_scan"] = ssm_checks(torch, dev, gen)
    for name, r in rows.items():
        print(f"check {name}: {r['shape']}; max_abs_err {r['max_abs_err']} ({r['tolerance']}); "
              f"kernel {r['ms']} ms, plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']} ms ({r['bound_by']})", flush=True)
    print(f"check pchase latency chain at the datasheet's {rows['pchase']['latency_level']} "
          f"latency: {rows['pchase']['latency_bound_ms']} ms (spec-sheet figure)", flush=True)
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
                     "2048; fp32 1e-4 (rows 1e-4) at S 256",
        "max_abs_err_bf16_s2048": flat2k["max_abs_err"],
        "row_rel_err_bf16_s2048": flat2k["row_rel_err"],
        "max_abs_err_fp32_s256": flat32["max_abs_err"],
        **model_layout("gemma-2b"),
        **{f"{k}_hd112": v for k, v in hd112.items()},
    }
    print(f"check flash_attention at gemma-2b's q (4, 1000, 8, 256) bf16: "
          f"{ {k: v for k, v in row.items() if not k.endswith('_hd112')} }", flush=True)
    return row


def ssm_checks(torch, dev, gen) -> dict:
    """ssm_scan at zamba2-7b's main-path shape: u (4, 1024, 112, 64) (S 1000
    padded to the chunk), a_log (4, 1024, 112) f32 at the init's decay
    (-softplus of a unit normal, ~0.8 a step), head-shared B/C (4, 1024, 64),
    chunk 256; bf16 (rtol/atol 2e-2: one rounding of y) and fp32 (1e-4: sum
    order) against the chunked plain version, fp32 again at a slow decay
    (-softplus(N(-5, 1)), ~0.007 a step, where the state carried across the
    4 chunks and the key tiles far below the diagonal decide y; at the init's
    decay they add ~0), and fp32 at S 256 against the sequential recurrence.
    Tolerances are relative to max |y|."""
    import torch.nn.functional as F

    from repro_torch.kernels import _util, ref
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    bsz, s, h, p, n, chunk = LM_BATCH, 1024, 112, 64, 64, 256

    def inputs(dtype, steps=s, shift=0.0):
        a = -F.softplus(torch.randn((bsz, steps, h), generator=gen, device=dev) + shift)
        u = (torch.randn((bsz, steps, h, p), generator=gen, device=dev) * 0.5).to(dtype)
        b, c = ((torch.randn((bsz, steps, n), generator=gen, device=dev) * 0.5).to(dtype)
                for _ in range(2))
        return u, a, b, c

    def plain(scan, *args):
        return _util.unflatten_heads(scan(*_util.flatten_ssm(*args[:4]), *args[4:]), bsz)

    ins = inputs(torch.float32)
    err32 = check_close("ssm_scan fp32", ssm_scan_cuda(*ins, chunk=chunk),
                        plain(ref.ssm_scan_chunked_ref, *ins, chunk), 1e-4, 1e-4)
    ins = inputs(torch.float32, shift=-5.0)
    err32_slow = check_close("ssm_scan fp32 at a slow decay", ssm_scan_cuda(*ins, chunk=chunk),
                             plain(ref.ssm_scan_chunked_ref, *ins, chunk), 1e-4, 1e-4)
    ins = inputs(torch.float32, 256)
    err_seq = check_close("ssm_scan fp32 S 256 vs the sequential recurrence",
                          ssm_scan_cuda(*ins, chunk=chunk), plain(ref.ssm_scan_ref, *ins),
                          1e-4, 1e-4)
    u, a, b, c = inputs(torch.bfloat16)
    err = check_close("ssm_scan bf16", ssm_scan_cuda(u, a, b, c, chunk=chunk).float(),
                      plain(ref.ssm_scan_chunked_ref, u, a, b, c, chunk).float(), 2e-2, 2e-2)
    flat = _util.flatten_ssm(u, a, b, c)  # the plain version's own layout, made untimed
    nbytes = 2 * u.numel() * u.element_size() + a.numel() * 4 + 2 * b.numel() * b.element_size()
    causal = chunk * (chunk + 1) // 2  # (t, s) pairs with s <= t in a chunk
    flops = bsz * h * (s // chunk) * (2 * causal * (n + p) + 4 * chunk * p * n)
    bound_ms, bound_by = bound(flops, nbytes, BF16_FLOPS)
    return {
        "shape": "u (4, 1024, 112, 64) bf16, a_log (4, 1024, 112) f32, b/c (4, 1024, 64) bf16, "
                 "chunk 256",
        "tolerance": "bf16 rtol 2e-2, atol 2e-2; fp32 1e-4 (also at a slow decay, and at S 256 "
                     "against the sequential recurrence); relative to max |y|",
        "max_abs_err": err, "max_abs_err_fp32": err32, "max_abs_err_fp32_slow_decay": err32_slow,
        "max_abs_err_fp32_sequential": err_seq,
        "ms": time_ms(torch, lambda: ssm_scan_cuda(u, a, b, c, chunk=chunk), 10),
        "plain_ms": time_ms(torch, lambda: ref.ssm_scan_chunked_ref(*flat, chunk), 3),
        "library_ms": None,  # no single PyTorch call computes this scan
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_ms_fp32_pipes": flops / FP32_FLOPS * 1e3,
    }


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
        "launches": counts,
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

    def run(m, c):
        out, counts = {}, {}

        def call(key, fn):
            _util.reset_launch_counts()
            res, out[f"{key}_s"] = timed(fn)
            counts[key] = _util.launch_counts()
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

    with torch.inference_mode():
        # warm-up: cuBLAS handles and the kernels' shared-memory attributes
        model.loss_fn(params, {"tokens": seq[:1, :32], "targets": seq[:1, 1:33]})
        run_out, counts = run(model, cfg)
        plain, plain_counts = run(plain_model, plain_cfg)
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
        **agree, "launches": counts, "phase_s": time.perf_counter() - phase_start,
    }
    print("zamba: " + json.dumps(res), flush=True)
    if max(agree.values()) > 0.1:
        raise AssertionError(f"zamba: outputs disagree by more than 0.1 of their max: {agree}")
    # with random weights the loss sits near ln(vocab) whatever the layers compute,
    # so 0.1 cannot catch a wrong layer; the kernels' own rounding is ~2e-5
    if agree["loss_vs_plain"] > LOSS_RTOL:
        raise AssertionError(f"zamba: loss differs from the plain path's by "
                             f"{agree['loss_vs_plain']} relative, over {LOSS_RTOL}")
    total = {}
    for c in counts.values():
        add_counts(total, c)
    return total


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
    counts, _ = main_path(torch, dev)
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
                      if k in ("latency_bound_ms", "tflops", "row_rel_err", "sweep_256mib")
                      or k.endswith(("_hd112", "_bf16"))})
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
