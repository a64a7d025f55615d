"""`HardwareModel` — the machine-readable analogue of the paper's Table 3.1.

The paper's meta-contribution is a *quantitative hardware model distilled
from microbenchmarks*, presented as a cross-generation comparison (T4 vs P4
vs V100).  ``HardwareModel`` is that object: every consumer (roofline,
autotuner, straggler detector, modeled benchmarks) reads hardware facts from
here, never from scattered constants.  Instances are registered in the
:mod:`repro_torch.hw.db` spec database and looked up by name or alias.

``peak_flops`` is per-dtype (FLOP/s per chip) because the paper's headline
TensorCore result (Table 4.3) *is* a per-dtype table: fp16 runs ~5.8x fp32
on T4, int8 ~1.8x fp16.  ``peak()`` takes an optional ``fallback=`` dtype
(or chain of dtypes) for parts that don't expose the requested precision —
the autotuner uses it so bf16/fp8 tile costing degrades to the nearest
supported precision instead of crashing.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Iterable, Optional, Union


class UnknownDtypeError(KeyError):
    """Requested a per-dtype peak a part does not publish.

    Subclasses ``KeyError`` for backwards compatibility with callers that
    caught the old bare ``KeyError`` from ``HardwareModel.peak``.
    """

    def __init__(self, part: str, dtype: str, available: Iterable[str]):
        self.part = part
        self.dtype = dtype
        self.available = tuple(sorted(available))
        super().__init__(
            f"{part}: no peak for dtype {dtype!r}; available: "
            f"{', '.join(self.available) or '(none)'} — pass fallback=<dtype> "
            f"to cost against the nearest supported precision"
        )

    def __str__(self) -> str:  # KeyError str() quotes its arg; keep it readable
        return self.args[0]


@dataclass(frozen=True)
class MemoryLevel:
    name: str
    size_bytes: int  # capacity (0 = unbounded, e.g. DRAM/HBM)
    latency_ns: float  # dependent-load latency
    bandwidth_Bps: float  # sustained streaming bandwidth
    line_bytes: int = 0
    shared: bool = False  # shared across cores/SMs or private


@dataclass(frozen=True)
class HardwareModel:
    name: str
    # compute
    peak_flops: dict  # dtype name -> FLOP/s (per chip)
    clock_hz: float
    num_cores: int
    # memory
    levels: tuple  # tuple[MemoryLevel, ...] fastest-first
    main_memory_Bps: float
    main_memory_bytes: int
    # on-chip staging (VMEM on TPU, smem+L1 on GPU)
    staging_bytes: int
    staging_Bps: float
    # interconnect
    ici_Bps_per_link: float = 0.0
    ici_links: int = 0
    dci_Bps: float = 0.0  # cross-pod (data-center interconnect)
    # power/thermal envelope (throttle model inputs, paper §4.5)
    power_limit_w: float = 0.0
    max_temp_c: float = 0.0
    idle_power_w: float = 0.0
    # identity/provenance (spec-database axes)
    vendor: str = ""  # "nvidia" | "google" | ...
    arch: str = ""  # microarchitecture family: "turing", "hopper", ...
    year: int = 0  # launch year (cross-generation ordering)
    source: str = ""  # where the numbers come from (paper table, datasheet)

    def peak(
        self,
        dtype: str,
        fallback: Optional[Union[str, Iterable[str]]] = None,
    ) -> float:
        """Per-chip peak FLOP/s for ``dtype``.

        ``fallback`` is a dtype name (or an ordered chain of names) tried
        when ``dtype`` itself is not published for this part.  With no
        usable fallback, raises :class:`UnknownDtypeError` listing the
        dtypes the part does support.
        """
        if dtype in self.peak_flops:
            return self.peak_flops[dtype]
        if fallback is not None:
            chain = (fallback,) if isinstance(fallback, str) else tuple(fallback)
            for fb in chain:
                if fb in self.peak_flops:
                    return self.peak_flops[fb]
        raise UnknownDtypeError(self.name, dtype, self.peak_flops)

    def supports(self, dtype: str) -> bool:
        return dtype in self.peak_flops

    def dtypes(self) -> tuple:
        """Published peak dtypes, fastest first."""
        return tuple(sorted(self.peak_flops, key=self.peak_flops.get, reverse=True))

    def level(self, name: str) -> MemoryLevel:
        for lvl in self.levels:
            if lvl.name == name:
                return lvl
        raise KeyError(
            f"{self.name}: no memory level {name!r}; "
            f"levels: {', '.join(l.name for l in self.levels)}"
        )

    def mxu_align(self) -> int:
        return 128

    def to_json(self) -> str:
        d = asdict(self)
        d["levels"] = [asdict(l) for l in self.levels]
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "HardwareModel":
        d = json.loads(s)
        d["levels"] = tuple(MemoryLevel(**l) for l in d["levels"])
        d["peak_flops"] = dict(d["peak_flops"])
        return HardwareModel(**d)


def fit_from_probes(
    name: str,
    plateau_levels: list,  # [(latency_ns, size_bytes_boundary_or_None), ...]
    stream_Bps: float,
    matmul_flops: dict,
    clock_hz: float = 0.0,
    register: bool = True,
) -> HardwareModel:
    """Build a HardwareModel from dissect.py probe output (measure mode).

    With ``register=True`` (default) the fitted model is registered into the
    spec database under ``name`` (overwriting any previous fit), so measured
    parts are queryable/comparable exactly like the paper presets:
    ``repro_torch.hw.compare("measured-host", "T4")``.
    """
    levels = []
    for i, (lat, size) in enumerate(plateau_levels):
        levels.append(
            MemoryLevel(
                name=f"level{i}",
                size_bytes=int(size) if size else 0,
                latency_ns=float(lat),
                bandwidth_Bps=stream_Bps,
            )
        )
    hw = HardwareModel(
        name=name,
        peak_flops=dict(matmul_flops),
        clock_hz=clock_hz,
        num_cores=1,
        levels=tuple(levels),
        main_memory_Bps=stream_Bps,
        main_memory_bytes=0,
        staging_bytes=levels[0].size_bytes if levels else 0,
        staging_Bps=stream_Bps,
        source="fit_from_probes",
    )
    if register:
        from . import db

        db.register(hw, overwrite=True)
    return hw
