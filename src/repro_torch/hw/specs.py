"""Registered presets: the paper's generations and their successors.

Three provenance classes, recorded per-part in ``source``:

- **paper-measured** — the T4 record holds the paper's own *measured*
  numbers (Table 3.1 memory hierarchy, Table 4.3 matmul throughput), so
  validation tests can assert against published results.
- **datasheet** — P4/V100 (the paper's comparison columns) and the
  successor parts (A100/H100/B200, tracked by the sequel dissection papers
  in PAPERS.md) use vendor datasheet peaks (dense, no sparsity) with
  cache latencies from the respective microbenchmark papers where
  available; treat them as modeled anchors, not measurements.
- **assignment constants** — TPU v5e, the dry-run/roofline target.

Latency entries are dependent-load latencies converted to ns at the part's
boost clock.  ``peak_flops`` keys use jnp dtype names (plus ``int4``/``int1``
for the paper's sub-byte TensorCore modes and ``tf32`` where a part has a
distinct TF32 path).
"""
from __future__ import annotations

from .db import register
from .model import HardwareModel, MemoryLevel

# ---------------------------------------------------------------------------
# TPU v5e — the roofline/dry-run target
# ---------------------------------------------------------------------------
TPU_V5E = register(
    HardwareModel(
        name="tpu-v5e",
        peak_flops={
            "bfloat16": 197e12,
            "float32": 49.25e12,  # MXU f32 path ~ bf16/4
            "int8": 394e12,
        },
        clock_hz=1.70e9,  # ~940 MHz x2 issue equivalent; per-chip effective
        num_cores=1,  # v5e is single-TensorCore per chip
        levels=(
            MemoryLevel("vreg", 512 * 1024, 0.6, 0.0, line_bytes=4 * 128),
            MemoryLevel("vmem", 128 * 1024 * 1024, 12.0, 3.3e12, line_bytes=4 * 8 * 128),
            MemoryLevel("hbm", 16 * 1024**3, 450.0, 819e9, line_bytes=512, shared=True),
        ),
        main_memory_Bps=819e9,
        main_memory_bytes=16 * 1024**3,
        staging_bytes=128 * 1024 * 1024,
        staging_Bps=3.3e12,
        ici_Bps_per_link=50e9,  # per the assignment: ~50 GB/s/link
        ici_links=4,  # 2D torus
        dci_Bps=25e9,  # cross-pod effective per-chip share (assumption, see DESIGN)
        power_limit_w=170.0,
        max_temp_c=90.0,
        idle_power_w=60.0,
        vendor="google",
        arch="tpu-v5e",
        year=2023,
        source="assignment constants",
    ),
    aliases=("v5e", "tpu_v5e", "tpuv5e"),
)


# ---------------------------------------------------------------------------
# The paper's T4 (Table 3.1 / 4.3, converted to SI) — validation anchor
# ---------------------------------------------------------------------------
_T4_CLK = 1.59e9  # 1590 MHz max graphics clock

T4_PAPER = register(
    HardwareModel(
        name="nvidia-t4-paper",
        peak_flops={
            # paper Table 4.3 measured matmul throughput (not theoretical peaks)
            "float64": 253e9,
            "float32": 7.174e12,
            "float16": 41.616e12,
            "int8": 74.934e12,
            "int4": 114.384e12,
            "int1": 552.230e12,
        },
        clock_hz=_T4_CLK,
        num_cores=40,  # SMs
        levels=(
            # latency_ns = cycles / 1.59 GHz; sizes from Table 3.1
            MemoryLevel("L1", 64 * 1024, 32 / _T4_CLK * 1e9, 58.8 * 40 * _T4_CLK, 32),
            MemoryLevel("L2", 4096 * 1024, 188 / _T4_CLK * 1e9, 1.27e12, 64, shared=True),
            MemoryLevel("global", 15 * 1024**3, 616 / _T4_CLK * 1e9, 220e9, 512, shared=True),
        ),
        main_memory_Bps=220e9,  # measured (theoretical 320; ratio 68.8%, Tab 3.1)
        main_memory_bytes=15 * 1024**3,
        staging_bytes=64 * 1024 * 40,  # shared memory per chip
        staging_Bps=3.662e12,  # Tab 3.1 actual shared bw
        power_limit_w=70.0,
        max_temp_c=85.0,
        idle_power_w=20.0,
        vendor="nvidia",
        arch="turing",
        year=2018,
        source="paper Tab 3.1 / Tab 4.3 (measured)",
    ),
    aliases=("t4", "t4-paper", "tesla-t4"),
)


# ---------------------------------------------------------------------------
# The paper's comparison columns: P4 (Pascal) and V100 (Volta)
# ---------------------------------------------------------------------------
_P4_CLK = 1.114e9  # Tesla P4 boost

P4 = register(
    HardwareModel(
        name="nvidia-p4",
        peak_flops={
            # GP104 datasheet, dense: fp32 2*2560*clk; int8 via dp4a = 4x fp32;
            # Pascal Tesla fp16 runs at the crippled 1/64 fp32 rate — keeping
            # it in the table is the point: the T4/P4 fp16 ratio is ~467x,
            # the TensorCore story the paper opens with.
            "float64": 0.178e12,
            "float32": 5.704e12,
            "float16": 0.089e12,
            "int8": 22.8e12,
        },
        clock_hz=_P4_CLK,
        num_cores=20,  # SMs
        levels=(
            MemoryLevel("L1", 24 * 1024, 82 / _P4_CLK * 1e9, 0.0, 32),
            MemoryLevel("L2", 2048 * 1024, 216 / _P4_CLK * 1e9, 0.0, 32, shared=True),
            MemoryLevel("global", 8 * 1024**3, 545 / _P4_CLK * 1e9, 192e9, 32, shared=True),
        ),
        main_memory_Bps=192e9,  # GDDR5 theoretical
        main_memory_bytes=8 * 1024**3,
        staging_bytes=96 * 1024 * 20,
        staging_Bps=1.6e12,
        power_limit_w=75.0,
        max_temp_c=85.0,
        idle_power_w=15.0,
        vendor="nvidia",
        arch="pascal",
        year=2016,
        source="datasheet + paper Ch.3 comparison",
    ),
    aliases=("p4", "tesla-p4"),
)

_V100_CLK = 1.38e9  # V100 PCIe boost

V100 = register(
    HardwareModel(
        name="nvidia-v100",
        peak_flops={
            # GV100 datasheet, dense: fp16 on 1st-gen TensorCores (8x fp32),
            # int8 via dp4a (no int8 TC mode on Volta)
            "float64": 7.066e12,
            "float32": 14.13e12,
            "float16": 113.0e12,
            "int8": 56.5e12,
        },
        clock_hz=_V100_CLK,
        num_cores=80,  # SMs
        levels=(
            MemoryLevel("L1", 128 * 1024, 28 / _V100_CLK * 1e9, 0.0, 32),
            MemoryLevel("L2", 6144 * 1024, 193 / _V100_CLK * 1e9, 2.2e12, 64, shared=True),
            MemoryLevel("global", 16 * 1024**3, 1029 / _V100_CLK * 1e9, 750e9, 64, shared=True),
        ),
        main_memory_Bps=750e9,  # HBM2, measured ~83% of the 900 GB/s theoretical
        main_memory_bytes=16 * 1024**3,
        staging_bytes=96 * 1024 * 80,
        staging_Bps=12.0e12,
        power_limit_w=250.0,
        max_temp_c=85.0,
        idle_power_w=25.0,
        vendor="nvidia",
        arch="volta",
        year=2017,
        source="datasheet + Volta dissection (arXiv:1804.06826)",
    ),
    aliases=("v100", "tesla-v100"),
)


# ---------------------------------------------------------------------------
# Successors tracked by the sequel dissections (Ampere / Hopper / Blackwell)
# ---------------------------------------------------------------------------
_A100_CLK = 1.41e9

A100 = register(
    HardwareModel(
        name="nvidia-a100-sxm",
        peak_flops={
            # dense (no 2:4 sparsity), A100 SXM 80GB datasheet
            "float64": 9.7e12,
            "float32": 19.5e12,
            "tf32": 156e12,
            "bfloat16": 312e12,
            "float16": 312e12,
            "int8": 624e12,
            "int4": 1248e12,
        },
        clock_hz=_A100_CLK,
        num_cores=108,  # SMs
        levels=(
            MemoryLevel("L1", 192 * 1024, 33 / _A100_CLK * 1e9, 0.0, 32),
            MemoryLevel("L2", 40 * 1024**2, 200 / _A100_CLK * 1e9, 5.1e12, 64, shared=True),
            MemoryLevel("global", 80 * 1024**3, 404 / _A100_CLK * 1e9, 2.039e12, 64, shared=True),
        ),
        main_memory_Bps=2.039e12,
        main_memory_bytes=80 * 1024**3,
        staging_bytes=164 * 1024 * 108,
        staging_Bps=19.5e12,
        ici_Bps_per_link=50e9,  # NVLink3: 12 links x 50 GB/s
        ici_links=12,
        power_limit_w=400.0,
        max_temp_c=90.0,
        idle_power_w=55.0,
        vendor="nvidia",
        arch="ampere",
        year=2020,
        source="datasheet + Ampere dissection (arXiv:1808.00734 lineage)",
    ),
    aliases=("a100", "a100-sxm"),
)

_H100_CLK = 1.83e9

H100 = register(
    HardwareModel(
        name="nvidia-h100-sxm",
        peak_flops={
            # dense, H100 SXM datasheet; fp8 on 4th-gen TensorCores
            "float64": 34e12,
            "float32": 67e12,
            "tf32": 494.5e12,
            "bfloat16": 989e12,
            "float16": 989e12,
            "float8_e4m3fn": 1979e12,
            "int8": 1979e12,
        },
        clock_hz=_H100_CLK,
        num_cores=132,  # SMs
        levels=(
            MemoryLevel("L1", 256 * 1024, 32 / _H100_CLK * 1e9, 0.0, 32),
            MemoryLevel("L2", 50 * 1024**2, 273 / _H100_CLK * 1e9, 7.5e12, 64, shared=True),
            MemoryLevel("global", 80 * 1024**3, 650 / _H100_CLK * 1e9, 3.35e12, 64, shared=True),
        ),
        main_memory_Bps=3.35e12,
        main_memory_bytes=80 * 1024**3,
        staging_bytes=228 * 1024 * 132,
        staging_Bps=33e12,
        ici_Bps_per_link=50e9,  # NVLink4: 18 links x 50 GB/s
        ici_links=18,
        power_limit_w=700.0,
        max_temp_c=90.0,
        idle_power_w=70.0,
        vendor="nvidia",
        arch="hopper",
        year=2022,
        source="datasheet + Hopper dissection (arXiv:2402.13499)",
    ),
    aliases=("h100", "h100-sxm"),
)

_B200_CLK = 1.965e9

B200 = register(
    HardwareModel(
        name="nvidia-b200",
        peak_flops={
            # dense, B200 datasheet; fp4 is the new Blackwell TC mode — the
            # paper's int4/int1 sub-byte story continued two generations on
            "float64": 40e12,
            "float32": 80e12,
            "tf32": 1.1e15,
            "bfloat16": 2.25e15,
            "float16": 2.25e15,
            "float8_e4m3fn": 4.5e15,
            "int8": 4.5e15,
            "fp4": 9.0e15,
        },
        clock_hz=_B200_CLK,
        num_cores=148,  # SMs
        levels=(
            MemoryLevel("L1", 256 * 1024, 33 / _B200_CLK * 1e9, 0.0, 32),
            MemoryLevel("L2", 126 * 1024**2, 290 / _B200_CLK * 1e9, 14e12, 64, shared=True),
            MemoryLevel("global", 192 * 1024**3, 700 / _B200_CLK * 1e9, 8e12, 64, shared=True),
        ),
        main_memory_Bps=8e12,
        main_memory_bytes=192 * 1024**3,
        staging_bytes=228 * 1024 * 148,
        staging_Bps=40e12,
        ici_Bps_per_link=100e9,  # NVLink5: 18 links x 100 GB/s
        ici_links=18,
        power_limit_w=1000.0,
        max_temp_c=90.0,
        idle_power_w=90.0,
        vendor="nvidia",
        arch="blackwell",
        year=2024,
        source="datasheet + Blackwell dissection (arXiv:2507.10789)",
    ),
    aliases=("b200",),
)
