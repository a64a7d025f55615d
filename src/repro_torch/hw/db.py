"""The hardware spec database: register / get / query / compare.

The paper frames its T4 findings as one column of a cross-generation table
(T4 vs P4 vs V100), and its sequels (Volta, Ampere, Hopper, Blackwell
dissections) extend the same table over time.  This module is that table as
a queryable registry:

    repro_torch.hw.get("T4").peak("int8")
    repro_torch.hw.query(dtype="int8", min_peak=500e12)
    repro_torch.hw.compare("T4", "P4")["peak_ratio"]["int8"]

Names are normalized (case-insensitive, ``_``/space -> ``-``) and every part
can carry aliases, so ``get("T4")``, ``get("t4")``, and the canonical
``get("nvidia-t4-paper")`` resolve to the same record.  ``resolve`` accepts
either a name or an existing :class:`HardwareModel`, which is how every
consumer (roofline, dissect, autotune) takes its ``hw=`` argument.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

from .model import HardwareModel

_DB: dict[str, HardwareModel] = {}
_ALIASES: dict[str, str] = {}  # normalized alias -> canonical name


def _norm(name: str) -> str:
    return name.strip().lower().replace("_", "-").replace(" ", "-")


def register(
    model: HardwareModel,
    aliases: Iterable[str] = (),
    overwrite: bool = False,
) -> HardwareModel:
    """Add ``model`` to the database under its canonical name plus aliases."""
    key = _norm(model.name)
    if not overwrite and key in _DB:
        raise ValueError(f"hardware model {model.name!r} already registered")
    _DB[key] = model
    for a in aliases:
        na = _norm(a)
        owner = _ALIASES.get(na)
        if na in _DB and na != key:
            raise ValueError(f"alias {a!r} shadows registered part {na!r}")
        if not overwrite and owner not in (None, key):
            raise ValueError(f"alias {a!r} already taken by {owner!r}")
        _ALIASES[na] = key
    return model


def unregister(name: str) -> None:
    """Remove a registration and its aliases (test helper)."""
    key = _ALIASES.get(_norm(name), _norm(name))
    _DB.pop(key, None)
    for a in [a for a, k in _ALIASES.items() if k == key]:
        del _ALIASES[a]


def get(name: str) -> HardwareModel:
    key = _norm(name)
    key = _ALIASES.get(key, key)
    try:
        return _DB[key]
    except KeyError:
        raise KeyError(
            f"unknown hardware {name!r}; registered: {', '.join(names())}"
        ) from None


def resolve(hw: Union[str, HardwareModel]) -> HardwareModel:
    """Name-or-model -> model; the contract behind every ``hw=`` argument."""
    if isinstance(hw, HardwareModel):
        return hw
    if isinstance(hw, str):
        return get(hw)
    raise TypeError(f"hw must be a name or HardwareModel, got {type(hw).__name__}")


def names() -> list:
    return sorted(_DB)


def models() -> list:
    return [_DB[n] for n in names()]


def query(
    dtype: Optional[str] = None,
    min_peak: float = 0.0,
    vendor: Optional[str] = None,
    arch: Optional[str] = None,
    min_memory_bytes: int = 0,
    min_memory_Bps: float = 0.0,
    max_power_w: float = 0.0,
    predicate: Optional[Callable[[HardwareModel], bool]] = None,
) -> list:
    """Parts matching every given filter, fastest-first on the queried dtype.

    ``dtype`` restricts to parts that publish that precision; ``min_peak``
    (FLOP/s) applies to that dtype's peak (requires ``dtype``).  Results are
    sorted by the dtype peak when given, else by name.
    """
    if min_peak and not dtype:
        raise ValueError("min_peak requires dtype= (which peak to gate on)")
    out = []
    for hw in _DB.values():
        if dtype is not None and not hw.supports(dtype):
            continue
        if dtype is not None and hw.peak(dtype) < min_peak:
            continue
        if vendor is not None and _norm(hw.vendor) != _norm(vendor):
            continue
        if arch is not None and _norm(hw.arch) != _norm(arch):
            continue
        if hw.main_memory_bytes < min_memory_bytes:
            continue
        if hw.main_memory_Bps < min_memory_Bps:
            continue
        if max_power_w and hw.power_limit_w > max_power_w:
            continue
        if predicate is not None and not predicate(hw):
            continue
        out.append(hw)
    if dtype is not None:
        out.sort(key=lambda h: h.peak(dtype), reverse=True)
    else:
        out.sort(key=lambda h: h.name)
    return out


def _ratio(a: float, b: float) -> float:
    return a / b if b else 0.0


def compare(
    a: Union[str, HardwareModel],
    b: Union[str, HardwareModel],
    dtypes: Optional[Iterable[str]] = None,
) -> dict:
    """Cross-generation comparison record for two parts (a relative to b).

    The shape of the paper's Tables 3.1/4.3 columns, as data: per-dtype
    peaks and their a/b ratios (over the shared dtypes unless ``dtypes``
    pins the list), memory capacity/bandwidth/clock/core/power ratios, and
    the two memory hierarchies side by side.
    """
    ha, hb = resolve(a), resolve(b)
    shared = [d for d in ha.dtypes() if hb.supports(d)]
    dts = list(dtypes) if dtypes is not None else shared
    return {
        "a": ha.name,
        "b": hb.name,
        "dtypes": dts,
        "peaks": {
            "a": {d: ha.peak(d) for d in dts if ha.supports(d)},
            "b": {d: hb.peak(d) for d in dts if hb.supports(d)},
        },
        "peak_ratio": {
            d: _ratio(ha.peak(d), hb.peak(d))
            for d in dts
            if ha.supports(d) and hb.supports(d)
        },
        "main_memory_Bps_ratio": _ratio(ha.main_memory_Bps, hb.main_memory_Bps),
        "main_memory_bytes_ratio": _ratio(ha.main_memory_bytes, hb.main_memory_bytes),
        "clock_ratio": _ratio(ha.clock_hz, hb.clock_hz),
        "num_cores_ratio": _ratio(ha.num_cores, hb.num_cores),
        "power_ratio": _ratio(ha.power_limit_w, hb.power_limit_w),
        "levels": {
            "a": [(l.name, l.size_bytes, l.latency_ns) for l in ha.levels],
            "b": [(l.name, l.size_bytes, l.latency_ns) for l in hb.levels],
        },
    }
