"""repro_torch.hw — the multi-generation hardware spec database.

The paper's quantitative hardware model, generalized from one part (the T4)
to a queryable registry of parts spanning the paper's own comparison
columns (P4, T4, V100), their successors tracked by the sequel dissections
(A100, H100, B200), and the TPU dry-run target (v5e):

    import repro_torch.hw as hw

    hw.get("T4").peak("int8")                  # Tab 4.3, as data
    hw.query(dtype="int8", min_peak=500e12)    # parts fast enough for a job
    hw.compare("T4", "P4")["peak_ratio"]       # the paper's generation story
    hw.names()                                 # everything registered

Consumers (``perfmodel.roofline``, ``core.dissect``, ``core.autotune``)
accept ``hw=`` as a name or a :class:`HardwareModel`; ``resolve`` is that
contract.  ``fit_from_probes`` registers measured parts into the same
database, so a dissected host is comparable against the paper presets.
This package is a copy of ``repro.hw``; the port keeps its own database.

See docs/hardware.md for the schema and how to add a part.
"""
from .db import (
    compare,
    get,
    models,
    names,
    query,
    register,
    resolve,
    unregister,
)
from .model import (
    HardwareModel,
    MemoryLevel,
    UnknownDtypeError,
    fit_from_probes,
)
from .specs import (
    A100,
    B200,
    H100,
    P4,
    T4_PAPER,
    TPU_V5E,
    V100,
)

__all__ = [
    "A100",
    "B200",
    "H100",
    "HardwareModel",
    "MemoryLevel",
    "P4",
    "T4_PAPER",
    "TPU_V5E",
    "UnknownDtypeError",
    "V100",
    "compare",
    "fit_from_probes",
    "get",
    "models",
    "names",
    "query",
    "register",
    "resolve",
    "unregister",
]
