"""HardwareModel-driven tile/layout selection — the paper's Chapter-1 loop
("know the hardware -> rewrite the access pattern") automated.

Port of ``repro.core.autotune``: the same model, candidates and return
values, over the port's own spec database (:mod:`repro_torch.hw`).  Scores
candidate block shapes with a two-term model (matrix-unit compute vs.
main-memory <-> on-chip traffic under the on-chip capacity constraint) and
returns the argmin.  Every entry point takes ``hw=`` as a DB name or a
``HardwareModel``, so tiles can be chosen for any registered part; the
default is the reference's, TPU v5e.  Consumed by the GEMM bench suite and
:mod:`repro_torch.kernels.api` autotuning (which passes the H100 for CUDA
tensors).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Union

from repro_torch.hw import TPU_V5E, HardwareModel
from repro_torch.hw import resolve as _resolve_hw

HwLike = Union[str, HardwareModel]  # every hw= arg takes a DB name or a model


@dataclass(frozen=True)
class TileChoice:
    bm: int
    bk: int
    bn: int
    predicted_s: float
    vmem_bytes: int
    notes: str = ""


_DTYPE_BYTES = {
    "float64": 8,
    "float32": 4,
    "tf32": 4,
    "bfloat16": 2,
    "float16": 2,
    "int8": 1,
    "float8_e4m3fn": 1,
    "float8_e5m2": 1,
    "int4": 0.5,
}

# nearest-supported-precision chains for parts that don't publish a peak for
# the requested dtype (documented fallback= semantics of HardwareModel.peak):
# bf16 on a pre-Ampere GPU costs at its fp16 TensorCore rate, fp8 on a
# pre-Hopper part at its int8 rate, everything else degrades to fp32.
_PEAK_FALLBACK = {
    "bfloat16": ("float16", "float32"),
    "float16": ("bfloat16", "float32"),
    "tf32": ("float32",),
    "float8_e4m3fn": ("int8", "bfloat16", "float32"),
    "float8_e5m2": ("int8", "bfloat16", "float32"),
    "int4": ("int8", "float32"),
    "int8": ("bfloat16", "float32"),
}


def peak_for(hw: HwLike, dtype: str) -> float:
    """Per-dtype peak from the spec DB with the autotuner's fallback chain —
    int8/bf16 tiles are costed at their own rates where the part publishes
    them, at the nearest supported precision where it doesn't."""
    return _resolve_hw(hw).peak(dtype, fallback=_PEAK_FALLBACK.get(dtype, ("float32",)))


def _dtype_bytes(dtype: str) -> float:
    try:
        return _DTYPE_BYTES[dtype]
    except KeyError:
        raise KeyError(
            f"no byte-size entry for dtype {dtype!r}; known: {sorted(_DTYPE_BYTES)}"
        ) from None


def dtype_name(dtype) -> str:
    """Normalize a torch/numpy dtype (or string) to the names the models use
    (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return str(getattr(dtype, "name", dtype)).removeprefix("torch.")


def matmul_time_model(
    m: int, k: int, n: int, bm: int, bk: int, bn: int, dtype: str, hw: HwLike
) -> tuple[float, int]:
    """(predicted seconds, VMEM working set).

    ``hw`` is a spec-DB name or a :class:`HardwareModel`.  Traffic model: A
    is streamed once per N-block column, B once per M-block row, C written
    once:
        bytes = (n/bn) * m*k + (m/bm) * k*n + m*n
    Compute: 2mnk / peak(dtype) via :func:`peak_for` (per-dtype DB peaks
    with the nearest-precision fallback), assuming full MXU utilization for
    128-aligned tiles, derated for misaligned ones.
    """
    hw = _resolve_hw(hw)
    eb = _dtype_bytes(dtype)
    traffic = (n // bn) * m * k * eb + (m // bm) * k * n * eb + m * n * eb
    t_mem = traffic / hw.main_memory_Bps
    align = hw.mxu_align()
    eff = 1.0
    for b in (bm, bk, bn):
        if b % align:
            eff *= max(b / (align * -(-b // align)), 0.25)
    t_compute = 2.0 * m * n * k / (peak_for(hw, dtype) * eff)
    vmem = int((bm * bk + bk * bn + bm * bn) * eb) + bm * bn * 4  # + fp32 acc
    return max(t_mem, t_compute), vmem


def choose_matmul_tiles(
    m: int,
    k: int,
    n: int,
    dtype: str = "bfloat16",
    hw: HwLike = TPU_V5E,
    candidates: Sequence[int] = (128, 256, 512, 1024),
    vmem_budget_frac: float = 0.8,
) -> TileChoice:
    hw = _resolve_hw(hw)
    budget = int(hw.staging_bytes * vmem_budget_frac)
    best: TileChoice | None = None
    for bm in candidates:
        if m % bm:
            continue
        for bk in candidates:
            if k % bk:
                continue
            for bn in candidates:
                if n % bn:
                    continue
                t, v = matmul_time_model(m, k, n, bm, bk, bn, dtype, hw)
                if v > budget:
                    continue
                if best is None or t < best.predicted_s:
                    best = TileChoice(bm, bk, bn, t, v)
    if best is None:  # fall back to whole-array (small problem)
        t, v = matmul_time_model(m, k, n, m, k, n, dtype, hw)
        best = TileChoice(m, k, n, t, v, notes="unblocked-fallback")
    return best


def choose_attention_chunk(
    seq_len: int,
    head_dim: int,
    n_heads_local: int,
    dtype: str = "bfloat16",
    hw: HwLike = TPU_V5E,
    candidates: Sequence[int] = (128, 256, 512, 1024, 2048),
    vmem_budget_frac: float = 0.6,
) -> int:
    """KV-chunk size for blockwise attention: biggest chunk whose working set
    (q tile + kv chunk + acc) fits the VMEM budget — larger chunks amortize
    HBM streaming (the Ch.1 width lesson applied to attention)."""
    hw = _resolve_hw(hw)
    eb = _dtype_bytes(dtype)
    budget = hw.staging_bytes * vmem_budget_frac
    best = candidates[0]
    for c in candidates:
        if c > seq_len:
            break
        # per-core working set: q block (128, hd), kv chunk (c, hd) x2, acc
        ws = (128 * head_dim + 2 * c * head_dim) * eb + 128 * head_dim * 4
        ws *= n_heads_local
        if ws <= budget:
            best = c
    return best


def choose_ssm_chunk(
    seq_len: int,
    head_dim: int,
    state_dim: int,
    dtype: str = "float32",
    hw: HwLike = TPU_V5E,
    candidates: Sequence[int] = (64, 128, 256, 512),
    vmem_budget_frac: float = 0.6,
) -> int:
    """Chunk length for the chunked-SSD scan: biggest chunk whose per-step
    working set (u/y tiles, B/C chunks, and the (chunk, chunk) intra-chunk
    decay matrix) fits the VMEM budget — same width-vs-capacity trade as
    :func:`choose_attention_chunk`, with the quadratic score tile dominating."""
    hw = _resolve_hw(hw)
    eb = _dtype_bytes(dtype)
    budget = hw.staging_bytes * vmem_budget_frac
    best = candidates[0]
    for c in candidates:
        if c > seq_len:
            break
        ws = c * (2 * head_dim + 2 * state_dim) * eb + c * c * 4  # + fp32 decay tile
        if ws <= budget:
            best = c
    return best
