"""Three-term roofline (port of ``repro.perfmodel.roofline``).

    compute term    = FLOPs_per_device / peak_FLOP/s_per_chip
    memory term     = bytes_per_device / HBM_bw_per_chip
    collective term = collective_bytes_per_device / link_bw

The FLOPs and bytes are per device, as :func:`.costs.extract_costs` counts
them on one device.  The dominant term is the bottleneck; the roofline
fraction is MODEL_FLOPS_time / max(term) — how close useful model math runs
to the hardware bound.

``hw=`` takes any part registered in the :mod:`repro_torch.hw` spec database (a
name like ``"T4"`` or a ``HardwareModel``); :func:`roofline_across` sweeps
the same workload over several generations at once — the paper's
cross-generation comparison applied to a whole compiled program instead of
a single kernel.  Parts with no published interconnect (single-chip cards
like the T4) get a zero collective term, and so does a program on one card
(its :class:`~.hlo.CollectiveStats` moves no bytes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Union

from repro_torch.hw import HardwareModel, resolve as _resolve_hw

from .costs import CompiledCosts
from .hlo import CollectiveStats


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float  # useful math (6ND / 2ND), global
    hlo_flops_global: float
    useful_ratio: float  # model_flops / hlo_flops_global
    roofline_fraction: float  # model compute time / dominant bound
    chips: int
    hw: str = ""  # spec-DB part the terms were computed against

    def summary(self) -> dict:
        return {
            "hw": self.hw,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops_global": self.hlo_flops_global,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }


def model_flops(kind: str, n_params_active: float, tokens: float) -> float:
    """6ND for training (fwd+bwd), 2ND for inference-only passes."""
    if kind == "train":
        return 6.0 * n_params_active * tokens
    return 2.0 * n_params_active * tokens


def roofline(
    costs: CompiledCosts,
    coll: CollectiveStats,
    chips: int,
    kind: str,
    n_params_active: float,
    tokens: float,
    hw: Union[str, HardwareModel] = "tpu-v5e",
    dtype: str = "bfloat16",
) -> RooflineTerms:
    hw = _resolve_hw(hw)
    peak = hw.peak(dtype, fallback=("float16", "float32"))
    t_c = costs.flops_per_device / peak
    t_m = costs.bytes_per_device / hw.main_memory_Bps
    # parts without a published interconnect (single-chip cards) have no
    # collective bound; their collective term is zero by construction
    t_x = (
        coll.per_device_bytes / hw.ici_Bps_per_link if hw.ici_Bps_per_link else 0.0
    )
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)
    mf = model_flops(kind, n_params_active, tokens)
    hlo_global = costs.flops_per_device * chips
    useful = mf / hlo_global if hlo_global else 0.0
    t_model = mf / (chips * peak)
    bound = max(terms.values())
    frac = t_model / bound if bound > 0 else 0.0
    return RooflineTerms(
        compute_s=t_c,
        memory_s=t_m,
        collective_s=t_x,
        dominant=dominant,
        model_flops=mf,
        hlo_flops_global=hlo_global,
        useful_ratio=useful,
        roofline_fraction=frac,
        chips=chips,
        hw=hw.name,
    )


def roofline_across(
    costs: CompiledCosts,
    coll: CollectiveStats,
    chips: int,
    kind: str,
    n_params_active: float,
    tokens: float,
    hws: Iterable[Union[str, HardwareModel]] = ("tpu-v5e", "T4", "A100", "H100"),
    dtype: str = "bfloat16",
) -> dict:
    """The same workload rooflined against several generations at once.

    Returns ``{part name: RooflineTerms}`` — one cross-generation comparison
    record per part, ordered as given.
    """
    out = {}
    for h in hws:
        rt = roofline(costs, coll, chips, kind, n_params_active, tokens,
                      hw=h, dtype=dtype)
        out[rt.hw] = rt
    return out
