"""Probe definitions — each maps one of the paper's benchmark families onto
a measurable PyTorch/CUDA workload.

Every probe runs on the device it is given (``device="cuda"`` by default,
the H100 the port targets); with no card visible it raises instead of
falling back to the host.  ``device="cpu"`` measures the host with the plain
PyTorch versions.

Probes that exercise a kernel take a ``backend`` argument routed through
:mod:`repro_torch.kernels.api` (``"cuda"`` | ``"torch"``).  Left unset, it
follows the device: the hand kernel on the card, the plain version on the
host — so the measure→model loop runs through the kernels by default.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import api
from repro_torch.kernels import op_latency as _ops

from . import pchase as pc
from .timing import resolve_device, time_fn


@dataclass(frozen=True)
class ProbeResult:
    name: str
    x: tuple  # sweep variable values
    y: tuple  # measured values
    unit: str
    meta: dict


# ---------------------------------------------------------------------------
# §3.1/3.2/3.8: pointer-chase latency vs. working set
# ---------------------------------------------------------------------------
def probe_pointer_chase(
    sizes_bytes: Sequence[int] = (),
    steps: int = 1 << 16,
    seed: int = 0,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> ProbeResult:
    """Dependent-load latency (ns/load) vs. footprint."""
    dev = resolve_device(device)
    be = api.resolve_backend(backend, dev)
    if not sizes_bytes:
        sizes_bytes = [1 << p for p in range(12, 27)]  # 4 KiB .. 64 MiB
    lats = []
    for sz in sizes_bytes:
        n = max(sz // 4, 8)
        perm = pc.single_cycle_successors(n, seed, dev)
        fn = api.pchase.bound(perm, steps, backend=be)
        t = time_fn(fn, perm, steps, warmup=2, reps=5)
        lats.append(t.min_s / steps * 1e9)
    return ProbeResult(
        "pointer_chase", tuple(int(s) for s in sizes_bytes), tuple(lats), "ns/load",
        {"steps": steps, "backend": be},
    )


def analyze_pointer_chase(res: ProbeResult, rel_jump: float = 0.35):
    """Plateau segmentation -> detected (latency, capacity) per level."""
    plats = pc.detect_plateaus(np.array(res.x), np.array(res.y), rel_jump)
    return plats, pc.capacities_from_plateaus(plats)


# ---------------------------------------------------------------------------
# §3.2/3.7: streaming bandwidth vs. footprint and block shape
# ---------------------------------------------------------------------------
def probe_stream_bandwidth(
    footprints: Sequence[int] = (),
    block_cols: int = 512,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> ProbeResult:
    dev = resolve_device(device)
    be = api.resolve_backend(backend, dev)
    if not footprints:
        footprints = [1 << p for p in range(16, 28)]  # 64 KiB .. 256 MiB
    bws = []
    for sz in footprints:
        cols = block_cols
        rows = max(sz // (4 * cols), 8)
        rows -= rows % 8
        x = torch.ones((rows, cols), dtype=torch.float32, device=dev)
        fn = api.stream_reduce.bound(x, block_rows=8, block_cols=cols, backend=be)
        t = time_fn(fn, x, warmup=2, reps=5)
        bws.append(x.numel() * 4 / t.min_s / 1e9)
    return ProbeResult(
        "stream_bandwidth", tuple(int(f) for f in footprints), tuple(bws), "GB/s",
        {"block_cols": block_cols, "backend": be},
    )


def probe_block_shape_bandwidth(
    footprint: int = 1 << 20,
    col_widths: Sequence[int] = (128, 256, 512, 1024, 2048),
    backend: Optional[str] = None,
    device: str = "cuda",
    vec_bytes: int = 16,
) -> ProbeResult:
    """The Ch.1 axpy experiment: bandwidth vs. tile width, each access
    ``vec_bytes`` wide on the card."""
    dev = resolve_device(device)
    be = api.resolve_backend(backend, dev)
    bws = []
    for cols in col_widths:
        rows = max(footprint // (4 * cols), 8)
        rows -= rows % 8
        x = torch.ones((rows, cols), dtype=torch.float32, device=dev)
        y = torch.ones((rows, cols), dtype=torch.float32, device=dev)
        fn = api.axpy.bound(x, y, 2.0, block_rows=8, block_cols=cols, vec_bytes=vec_bytes,
                            backend=be)
        t = time_fn(fn, x, y, 2.0, warmup=2, reps=5)
        bws.append(3 * x.numel() * 4 / t.min_s / 1e9)  # 2 reads + 1 write
    return ProbeResult(
        "block_shape_bandwidth", tuple(int(c) for c in col_widths), tuple(bws), "GB/s",
        {"footprint": footprint, "backend": be, "vec_bytes": vec_bytes},
    )


# ---------------------------------------------------------------------------
# §4.1: dependent-issue op latency table (Table 4.1 analogue)
# ---------------------------------------------------------------------------
def probe_op_latency(chain: int = 4096, width: int = 128, reps: int = 5,
                     device: str = "cuda") -> ProbeResult:
    """Dependent-chain latency per op (ns): a ``chain``-long loop where each
    iteration consumes the previous result (§4.1), with the loop overhead
    subtracted via a move-only baseline chain.

    The ops are the reference's ``_OP_TABLE`` rows with its constants
    (:data:`repro_torch.kernels.op_latency.OPS`).  On the card each chain is
    one launch of the ``op_latency`` kernel, which runs it in registers, timed
    with CUDA events (the minimum over ``reps``); the move-only launch takes
    the launch and the loop away.  On the CPU the chain runs as eager PyTorch
    ops, one op a step: the kernel's plain version.
    """
    dev = resolve_device(device)

    def run_chain(name):
        x0 = _ops.chain_input(_ops.OPS[name][0], width, dev)
        t = time_fn(lambda x: _ops.op_chain(name, x, chain), x0, warmup=2, reps=reps)
        return t.min_s / chain * 1e9

    base = run_chain("move")  # launch and loop overhead baseline
    names = tuple(n for n in _ops.OPS if n != "move")
    lats = tuple(max(run_chain(n) - base, 0.0) for n in names)
    return ProbeResult(
        "op_latency", names, lats, "ns/op",
        {"chain": chain, "base_ns": base, "backend": "cuda" if dev.type == "cuda" else "torch"},
    )


# ---------------------------------------------------------------------------
# §4.2: scatter-add contention (atomics analogue, Fig 4.1 scenarios)
# ---------------------------------------------------------------------------
def probe_scatter_contention(
    n_updates: int = 1 << 16, collisions: Sequence[int] = (1, 2, 4, 8, 16, 32),
    device: str = "cuda",
) -> ProbeResult:
    """Throughput (updates/s) of scatter-add with R threads per address."""
    dev = resolve_device(device)
    rates = []
    for r in collisions:
        m = max(n_updates // r, 1)
        tgt = torch.zeros((m,), dtype=torch.float32, device=dev)
        idx = torch.arange(m, dtype=torch.int64, device=dev).repeat_interleave(r)[:n_updates]
        val = torch.ones((n_updates,), dtype=torch.float32, device=dev)

        def fn(t, i, v):
            return t.index_add(0, i, v)

        tm = time_fn(fn, tgt, idx, val, warmup=2, reps=5)
        rates.append(n_updates / tm.min_s / 1e6)
    return ProbeResult(
        "scatter_contention", tuple(int(c) for c in collisions), tuple(rates),
        "Mupdates/s", {"n_updates": n_updates},
    )


# ---------------------------------------------------------------------------
# §4.4: matmul arithmetic throughput (Fig 4.2 / Table 4.3 analogue)
# ---------------------------------------------------------------------------
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def probe_matmul_throughput(
    sizes: Sequence[int] = (256, 512, 1024, 2048),
    dtypes: Sequence[str] = ("float32",),
    backend: Optional[str] = None,
    device: str = "cuda",
) -> ProbeResult:
    dev = resolve_device(device)
    be = api.resolve_backend(backend, dev)
    recs, keys = [], []
    int8_rows = []
    for dt in dtypes:
        tdt = _DTYPES[dt]
        for n in sizes:
            a = torch.ones((n, n), dtype=tdt, device=dev)
            b = torch.ones((n, n), dtype=tdt, device=dev)
            if tdt == torch.int8:
                # int8 goes to the library's int32-accumulating GEMM, as the
                # reference sends it to XLA (its kernel runs in the gemm_lp
                # suite) — tagged so a backend comparison can't mistake these
                # rows for the kernel path
                fn = torch._int_mm
                int8_rows.append(f"{dt}:{n}")
            else:
                fn = api.matmul.bound(a, b, backend=be)
            t = time_fn(fn, a, b, warmup=2, reps=5)
            keys.append(f"{dt}:{n}")
            recs.append(2 * n**3 / t.min_s / 1e9)
    meta = {"backend": be}
    if int8_rows:
        meta["torch_only_rows"] = tuple(int8_rows)
    return ProbeResult("matmul_throughput", tuple(keys), tuple(recs), "GFLOP/s", meta)


# ---------------------------------------------------------------------------
# Tab 2.1 analogue: grid occupancy (programs vs. core count)
# ---------------------------------------------------------------------------
def probe_grid_occupancy(
    rows_per_program: int = 256,
    programs: Sequence[int] = (1, 2, 3, 4, 6, 8),
    backend: Optional[str] = None,
    device: str = "cuda",
) -> ProbeResult:
    """Read throughput vs. array size in units of ``rows_per_program`` rows
    (the reference's programs of a TPU grid); the card's kernel sizes its own
    grid, so this reads how throughput grows with the work in flight."""
    dev = resolve_device(device)
    be = api.resolve_backend(backend, dev)
    rates = []
    for g in programs:
        x = torch.ones((g * rows_per_program, 512), dtype=torch.float32, device=dev)
        fn = api.stream_reduce.bound(x, block_rows=rows_per_program, block_cols=512,
                                     backend=be)
        t = time_fn(fn, x, warmup=2, reps=5)
        rates.append(x.numel() * 4 / t.min_s / 1e9)
    return ProbeResult(
        "grid_occupancy", tuple(int(p) for p in programs), tuple(rates), "GB/s",
        {"rows_per_program": rows_per_program, "backend": be},
    )
