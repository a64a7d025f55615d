"""Kernel-layer numerics guard: shadow-oracle checks, saturation sentinels,
per-op degradation.

Port of ``repro.kernels.guard``.  A hand kernel that returns plausible but
wrong values, or a low-precision accumulation that saturates (the regime the
paper's Table 4.3 ladder exists to exploit), is invisible until it corrupts
tokens.  This module makes the kernel layer verify itself at run time,
scoped by the context-local policy (``kernel_policy(guard="off" | "sample" |
"shadow")``):

- **shadow-oracle checking** — a seed-deterministic sample of eager
  :class:`~repro_torch.kernels.api.KernelOp` calls (every call under
  ``"shadow"``, every ``sample_stride``-th under ``"sample"``) re-executes on
  the ``torch`` oracle backend and compares under the per-dtype tolerance
  ladder of :func:`tolerance`.  The comparison runs in torch on the tensors'
  device; only its scalars cross to the host.  A mismatch raises a typed
  :class:`KernelDriftError` carrying op, backend, shapes, and a max-ulp
  report.
- **overflow/saturation sentinels** — per-op hooks (registered for
  ``matmul`` / ``flash_attention`` by ``kernels.api``) bound the saturated
  fraction of low-precision accumulation outputs; past
  ``GuardConfig.saturation_threshold`` they raise :class:`SaturationError`.
  Saturation is a property of the inputs — the oracle saturates identically
  — so the sentinel raises without quarantining the op.
- **per-op degradation** — a drifting or faulting op is quarantined to the
  ``torch`` backend *for that op only*, with breaker-style exponential
  cooldown and half-open re-probe.  While a CUDA graph is being captured
  (:func:`tracing`) no result can be read back, so shadow checks skip there
  and only the quarantine routing applies.
- **no fallback on the card** — on CUDA tensors a hand kernel runs or the
  call raises.  A real native failure or drift there trips the breaker and
  re-raises whatever ``degrade`` / ``on_drift`` say, and later calls of an
  op quarantined so raise :class:`KernelGuardError` until it is revived.
  Only a breaker tripped by the chaos surface (:func:`inject_fault`,
  :func:`inject_drift`) lets the oracle serve card calls, so the reference's
  breaker sequence can still be driven on the card.  CPU tensors keep the
  reference's behaviour: their native path is the oracle's twin.

Guard activity accumulates in :class:`GuardMetrics` (checks run, drift
events, saturation fraction, ops degraded/revived) and emits schema-v1
records.  ``tolerance`` keeps the reference's ``hw="T4"`` default; callers on
the card pass ``hw="nvidia-h100-sxm"``.
"""
from __future__ import annotations

import warnings
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import hw as hwdb
from repro_torch.core.autotune import dtype_name

GUARD_MODES = ("off", "sample", "shadow")

# breaker states
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


# ---------------------------------------------------------------------------
# tolerance ladder (repro_torch.hw precision resolution -> ulp budgets)
# ---------------------------------------------------------------------------
#: mantissa bits per compute precision (ulp = 2**-mantissa relative)
_MANTISSA = {
    "float64": 52,
    "float32": 23,
    "tf32": 10,
    "float16": 10,
    "bfloat16": 7,
    "float8_e4m3fn": 3,
    "float8_e5m2": 2,
}

#: default ulp budget per resolved precision.  High precisions get a wide
#: budget (accumulation-order differences dominate, each ulp is tiny); low
#: precisions get a narrow one (a single ulp is already coarse — bf16's is
#: ~0.8% relative — and a wide budget would mask real drift).
_ULP_BUDGET = {
    "float64": 1024.0,
    "float32": 256.0,
    "tf32": 64.0,
    "float16": 32.0,
    "bfloat16": 4.0,
    "float8_e4m3fn": 2.0,
    "float8_e5m2": 2.0,
}

#: float-only restriction of ``core.autotune._PEAK_FALLBACK``: the chain a
#: requested dtype walks to find the precision the part actually computes in
#: (a float dtype must never resolve to an integer peak — the int entries in
#: the autotuner's chains cost *throughput*, not rounding behaviour).
_GUARD_FALLBACK = {
    "float64": ("float32",),
    "bfloat16": ("float16", "float32"),
    "float16": ("bfloat16", "float32"),
    "tf32": ("float32",),
    "float8_e4m3fn": ("bfloat16", "float16", "float32"),
    "float8_e5m2": ("bfloat16", "float16", "float32"),
}


@dataclass(frozen=True)
class Tolerance:
    """Per-dtype comparison tolerance derived from the hw precision ladder.

    ``resolved`` is the precision the comparison is costed in: the requested
    dtype when the part publishes a peak for it, else the first float in its
    fallback chain the part does publish (a part with no relevant published
    precision keeps the requested dtype).  ``exact`` marks integer/bool
    dtypes, which must match bit-for-bit.
    """

    dtype: str
    resolved: str
    ulps: float
    rtol: float
    atol: float
    exact: bool = False
    hw: str = "T4"


def _dtype_name(dtype) -> str:
    """A torch dtype, numpy dtype, numpy scalar type or string as its name."""
    if isinstance(dtype, torch.dtype):
        return dtype_name(dtype)
    return np.dtype(dtype).name


def _is_exact(name: str) -> bool:
    return name.startswith(("int", "uint")) or name == "bool"


def tolerance(dtype, hw: str = "T4", ulps: Optional[float] = None) -> Tolerance:
    """Tolerance for comparing a kernel result of ``dtype`` against the
    oracle, on part ``hw`` (a ``repro_torch.hw`` DB name or model).

    The dtype resolves through the part's published peaks via the float
    fallback chains (Table 4.3 ladder semantics: T4 publishes fp16 but not
    bf16, so a bf16 result is compared at fp16 precision); the resolved
    precision's ulp (``2**-mantissa``) times the per-precision budget gives
    ``rtol``, with an equal absolute floor for near-zero entries.
    """
    name = _dtype_name(dtype)
    if _is_exact(name):
        return Tolerance(dtype=name, resolved=name, ulps=0.0, rtol=0.0,
                         atol=0.0, exact=True, hw=str(hw))
    part = hwdb.resolve(hw)
    resolved = name
    if not part.supports(name):
        for fb in _GUARD_FALLBACK.get(name, ()):
            if part.supports(fb):
                resolved = fb
                break
    if resolved not in _MANTISSA:
        resolved = "float32"
    eps = 2.0 ** -_MANTISSA[resolved]
    budget = float(ulps) if ulps is not None else _ULP_BUDGET[resolved]
    return Tolerance(dtype=name, resolved=resolved, ulps=budget,
                     rtol=budget * eps, atol=budget * eps, hw=part.name)


# ---------------------------------------------------------------------------
# drift comparison
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DriftReport:
    """One shadow-oracle comparison: max abs/rel/ulp distances vs the
    tolerance that judged them (``max_ulp`` is in ulps of
    ``tol.resolved``)."""

    op: str
    backend: str
    shapes: tuple
    dtype: str
    ok: bool
    max_abs: float
    max_rel: float
    max_ulp: float
    checked: int
    tol: Tolerance
    error: str = ""  # set when the native path raised instead of drifting

    def describe(self) -> str:
        if self.error:
            return (f"op {self.op!r} [{self.backend}] shapes={self.shapes} "
                    f"raised: {self.error}")
        return (
            f"op {self.op!r} [{self.backend}] shapes={self.shapes} "
            f"dtype={self.dtype}: max_abs={self.max_abs:.3e} "
            f"max_rel={self.max_rel:.3e} max_ulp={self.max_ulp:.1f} over "
            f"{self.checked} elements (tolerance: {self.tol.ulps:g} ulp of "
            f"{self.tol.resolved} on {self.tol.hw}"
            + (", exact)" if self.tol.exact else ")")
        )


def compare(got: torch.Tensor, want: torch.Tensor, tol: Tolerance, *, op: str = "?",
            backend: str = "?") -> DriftReport:
    """Judge a native result against the oracle under ``tol``.

    Integer dtypes must match exactly; floats must agree on finiteness
    everywhere and sit within ``atol + rtol*|want|`` elementwise.  The
    arithmetic runs in float64 (int64 for integers) on ``got``'s device;
    only the report's scalars are read back.
    """
    w = want.to(got.device)
    shapes = (tuple(got.shape),)
    n = int(got.numel())
    if n == 0:
        return DriftReport(op=op, backend=backend, shapes=shapes, dtype=tol.dtype, ok=True,
                           max_abs=0.0, max_rel=0.0, max_ulp=0.0, checked=0, tol=tol)
    if tol.exact:
        same = got.shape == w.shape and bool(torch.equal(got, w.to(got.dtype)))
        max_abs = 0.0 if same else float((got.long() - w.long()).abs().max())
        return DriftReport(op=op, backend=backend, shapes=shapes,
                           dtype=tol.dtype, ok=same, max_abs=max_abs,
                           max_rel=max_abs, max_ulp=max_abs, checked=n, tol=tol)
    g64, w64 = got.double(), w.double()
    fin_g, fin_w = torch.isfinite(g64), torch.isfinite(w64)
    both = fin_g & fin_w
    zero = torch.zeros((), dtype=torch.float64, device=got.device)
    diff = torch.where(both, (g64 - w64).abs(), zero)
    ref = torch.where(both, w64.abs(), zero)
    eps = 2.0 ** -_MANTISSA[tol.resolved]
    max_abs, max_rel, max_ulp, outside, finite_bad = torch.stack([
        diff.max(),
        (diff / ref.clamp_min(1e-300)).max(),
        (diff / (eps * ref.clamp_min(1.0))).max(),
        (diff > tol.atol + tol.rtol * ref).any().double(),
        (fin_g != fin_w).any().double(),
    ]).tolist()  # the one read back to the host
    if finite_bad:
        max_ulp = float("inf")
    return DriftReport(op=op, backend=backend, shapes=shapes, dtype=tol.dtype,
                       ok=not finite_bad and not outside, max_abs=max_abs,
                       max_rel=max_rel, max_ulp=max_ulp, checked=n, tol=tol)


def _leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple, depth first (dicts in their
    sorted key order, as ``jax.tree_util`` flattens them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def trees_match(got, want, hw: str = "T4") -> tuple:
    """Compare two trees (e.g. serving-step outputs) leaf by leaf under the
    per-dtype tolerance ladder; returns ``(ok, detail)`` where ``detail``
    describes the worst-drifting leaf ('' when ok)."""
    g_leaves, w_leaves = _leaves(got), _leaves(want)
    if len(g_leaves) != len(w_leaves):
        return False, (f"tree structure differs: {len(g_leaves)} vs "
                       f"{len(w_leaves)} leaves")
    worst = None
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        tol = tolerance(g.dtype, hw=hw)
        rep = compare(g, w, tol, op=f"leaf[{i}]")
        if not rep.ok and (worst is None or rep.max_ulp > worst.max_ulp):
            worst = rep
    if worst is None:
        return True, ""
    return False, worst.describe()


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------
class KernelGuardError(RuntimeError):
    """Base class for guard-raised failures."""


class KernelDriftError(KernelGuardError):
    """A sampled kernel call disagreed with the torch oracle past tolerance.

    ``report`` is the full :class:`DriftReport` (op, backend, shapes, dtype,
    max abs/rel/ulp distances, and the :class:`Tolerance` that judged them).
    """

    def __init__(self, report: DriftReport):
        self.report = report
        self.op = report.op
        self.backend = report.backend
        self.shapes = report.shapes
        super().__init__("kernel drift: " + report.describe())


class SaturationError(KernelGuardError):
    """A low-precision accumulation saturated past the guard threshold.

    ``fraction`` is the saturated share of output entries, ``detail`` the
    sentinel's description of the bound that tripped.
    """

    def __init__(self, op: str, dtype: str, fraction: float, detail: str,
                 threshold: float):
        self.op = op
        self.dtype = dtype
        self.fraction = fraction
        super().__init__(
            f"op {op!r} saturated {fraction:.1%} of its {dtype} output "
            f"(threshold {threshold:.1%}): {detail}"
        )


# ---------------------------------------------------------------------------
# config / metrics / breaker state
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class GuardConfig:
    """Process-level guard settings (the *mode* lives on the kernel policy).

    - ``sample_stride`` / ``seed`` — under ``guard="sample"``, the n-th call
      of an op is shadow-checked when ``(n + seed) % sample_stride == 0``
      (seed-deterministic: the same call sequence checks the same calls).
    - ``hw`` — spec-DB part whose precision ladder derives the tolerances.
    - ``saturation_threshold`` — saturated output fraction past which the
      sentinel raises :class:`SaturationError`.
    - ``sentinels`` — enable the per-op saturation hooks.
    - ``degrade`` — quarantine a faulting op and serve it from the oracle
      (False, the default: re-raise the native failure).  On CUDA tensors
      only an injected fault may be served so (see the module docstring).
    - ``on_drift`` — ``"raise"`` (typed :class:`KernelDriftError`) or
      ``"oracle"`` (warn, quarantine, and return the oracle result; on CUDA
      tensors only for injected drift).
    - ``cooldown`` / ``max_cooldown_doublings`` / ``probe_checks`` — breaker
      shape: an open op waits ``cooldown * 2**min(fails-1, doublings)``
      guard-clock ticks, then half-opens; ``probe_checks`` consecutive clean
      live checks close it again.
    """

    sample_stride: int = 8
    seed: int = 0
    hw: str = "T4"
    saturation_threshold: float = 1.0 / 64.0
    sentinels: bool = True
    degrade: bool = False
    on_drift: str = "raise"
    cooldown: int = 16
    max_cooldown_doublings: int = 4
    probe_checks: int = 2

    def __post_init__(self):
        if self.sample_stride < 1:
            raise ValueError("sample_stride must be >= 1")
        if not 0.0 <= self.saturation_threshold <= 1.0:
            raise ValueError("saturation_threshold must be in [0, 1]")
        if self.on_drift not in ("raise", "oracle"):
            raise ValueError('on_drift must be "raise" or "oracle"')
        if self.cooldown < 1:
            raise ValueError("cooldown must be >= 1")
        if self.max_cooldown_doublings < 0:
            raise ValueError("max_cooldown_doublings must be >= 0")
        if self.probe_checks < 1:
            raise ValueError("probe_checks must be >= 1")


@dataclass
class OpBreaker:
    """Per-op circuit breaker (closed -> open -> half_open -> closed)."""

    state: str = BREAKER_CLOSED
    fail_count: int = 0
    opened_at: int = 0  # guard-clock tick of the last trip
    probe_ok: int = 0
    reason: str = ""
    injected: bool = False  # tripped by the chaos surface (may serve card calls)


class GuardMetrics:
    """Guard activity counters; ``to_records`` emits schema-v1 rows."""

    def __init__(self):
        self.checks = 0  # shadow-oracle comparisons run (incl. probes)
        self.drift_events = 0  # comparisons that failed tolerance
        self.sentinel_checks = 0  # saturation sentinel evaluations
        self.saturation_events = 0  # sentinel trips past threshold
        self.max_saturation_fraction = 0.0
        self.faults = 0  # native-path exceptions caught by the guard
        self.quarantines = 0  # breaker trips (op -> torch)
        self.half_opens = 0  # cooled-down ops re-probed
        self.revivals = 0  # half-open probes that closed the breaker
        self.degraded_calls = 0  # calls served by the oracle while open
        self.quarantined_ops: set = set()  # every op ever tripped

    def events(self) -> int:
        return self.drift_events + self.saturation_events + self.faults

    def summary(self) -> dict:
        return {
            "checks": self.checks,
            "drift_events": self.drift_events,
            "sentinel_checks": self.sentinel_checks,
            "saturation_events": self.saturation_events,
            "max_saturation_fraction": self.max_saturation_fraction,
            "faults": self.faults,
            "quarantines": self.quarantines,
            "half_opens": self.half_opens,
            "revivals": self.revivals,
            "degraded_calls": self.degraded_calls,
            "quarantined_ops": sorted(self.quarantined_ops),
        }

    def to_records(self, benchmark: str, prefix: str, x=None) -> list:
        """Schema-v1 rows: checks run, detection events, breaker activity."""
        from repro_torch.bench.schema import BenchRecord

        s = self.summary()
        shared = {"checks": s["checks"], "sentinel_checks": s["sentinel_checks"]}
        return [
            BenchRecord(
                name=f"{prefix}_checks",
                benchmark=benchmark,
                x=x,
                value=float(s["checks"]),
                unit="count",
                better="info",
                metrics={**shared, "degraded_calls": s["degraded_calls"]},
                info="shadow-oracle comparisons run",
            ),
            BenchRecord(
                name=f"{prefix}_events",
                benchmark=benchmark,
                x=x,
                value=float(self.events()),
                unit="count",
                better="info",
                metrics={
                    **shared,
                    "drift_events": s["drift_events"],
                    "saturation_events": s["saturation_events"],
                    "max_saturation_fraction": s["max_saturation_fraction"],
                    "faults": s["faults"],
                },
                info="guard detections (drift + saturation + native faults)",
            ),
            BenchRecord(
                name=f"{prefix}_degraded_ops",
                benchmark=benchmark,
                x=x,
                value=float(len(s["quarantined_ops"])),
                unit="count",
                better="info",
                metrics={
                    **shared,
                    "quarantines": s["quarantines"],
                    "half_opens": s["half_opens"],
                    "revivals": s["revivals"],
                    "degraded_calls": s["degraded_calls"],
                },
                info="distinct ops ever quarantined to the torch backend",
            ),
        ]


# ---------------------------------------------------------------------------
# sentinel / probe registries (populated by kernels.api at import time)
# ---------------------------------------------------------------------------
_SENTINELS: dict = {}  # op name -> fn(args, out) -> (fraction, detail)
_PROBES: dict = {}  # op name -> fn(device) -> (args tuple, kwargs dict)


def register_sentinel(op_name: str, fn: Callable) -> None:
    """Register a saturation sentinel: ``fn(args, out)`` returns the
    saturated output fraction in [0, 1] plus a human-readable detail."""
    _SENTINELS[op_name] = fn


def register_probe(op_name: str, factory: Callable) -> None:
    """Register a canonical-input factory used by :func:`attribute` /
    :func:`probe` to re-test an op outside any live call: ``factory(device)``
    returns ``(args, kwargs)`` for a small deterministic invocation on
    ``device``."""
    _PROBES[op_name] = factory


def probe_ops() -> list:
    # probes register when kernels.api imports; force it so a bare
    # `guard.verify_ops()` (e.g. the bench runner's --guard sweep) is never
    # vacuously empty
    from repro_torch.kernels import api  # noqa: F401

    return sorted(_PROBES)


def probe_device() -> torch.device:
    """Where the canonical probes run: the card when one is visible (its
    native backend is the hand kernel), else the CPU (whose native backend is
    the oracle itself, so a CPU probe can only catch an injected fault or
    drift)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


# ---------------------------------------------------------------------------
# guard state
# ---------------------------------------------------------------------------
class GuardState:
    """Process-global guard machinery: per-op sampling counters, breakers,
    fault/drift injections (the chaos surface), and :class:`GuardMetrics`.

    The *mode* is context-local (on the kernel policy); the state is global
    on purpose — a quarantine must hold across policy scopes and threads.
    """

    def __init__(self, config: Optional[GuardConfig] = None):
        self.config = config or GuardConfig()
        self.metrics = GuardMetrics()
        self.clock = 0  # advances once per guarded eager call
        self.breakers: dict = {}  # op name -> OpBreaker
        self._calls: dict = {}  # op name -> guarded-call count (sampling)
        self._probe_cache: dict = {}  # op name -> built (args, kwargs)
        # chaos injections
        self._fault_injections: dict = {}  # op name -> message
        self._drift_injections: dict = {}  # op name -> {"scale", "rng"}

    # -- breaker ---------------------------------------------------------
    def _cooldown_ticks(self, br: OpBreaker) -> int:
        cfg = self.config
        return cfg.cooldown * 2 ** min(max(br.fail_count - 1, 0),
                                       cfg.max_cooldown_doublings)

    def trip(self, op_name: str, reason: str, injected: bool = False) -> None:
        br = self.breakers.setdefault(op_name, OpBreaker())
        br.state = BREAKER_OPEN
        br.opened_at = self.clock
        br.fail_count += 1
        br.probe_ok = 0
        br.reason = reason
        br.injected = injected
        self.metrics.quarantines += 1
        self.metrics.quarantined_ops.add(op_name)

    def close(self, op_name: str) -> None:
        br = self.breakers.get(op_name)
        if br is not None and br.state != BREAKER_CLOSED:
            br.state = BREAKER_CLOSED
            br.probe_ok = 0
            br.reason = ""
            self.metrics.revivals += 1

    def serves_oracle(self, op_name: str, on_card: bool) -> bool:
        """Whether a call of ``op_name`` goes to the oracle: True while its
        breaker is open.  On the card only an injected trip may be served so;
        an op quarantined for a real failure raises instead."""
        br = self.breakers.get(op_name)
        if br is None or br.state != BREAKER_OPEN:
            return False
        if on_card and not br.injected:
            raise KernelGuardError(
                f"kernel op {op_name!r} is quarantined ({br.reason}); the port serves "
                f"no torch fallback for CUDA tensors: fix the kernel, or probe and "
                f"revive the op"
            )
        return True

    # -- native / oracle execution --------------------------------------
    def _run_native(self, op, args, kwargs, backend: str):
        """The op's native path with chaos injections applied: an injected
        fault raises before execution; injected drift perturbs the result
        with seeded noise (deterministic across identical call sequences;
        drawn on the host by numpy, as the reference draws it, and added on
        the result's device)."""
        msg = self._fault_injections.get(op.name)
        if msg is not None:
            raise RuntimeError(msg)
        out = op.bound(*args, backend=backend, **kwargs)(*args)
        inj = self._drift_injections.get(op.name)
        if inj is not None and out.is_floating_point():
            noise = torch.from_numpy(inj["rng"].standard_normal(tuple(out.shape)))
            scale = inj["scale"] * (float(out.double().abs().mean()) + 1.0)
            out = out + (noise * scale).to(device=out.device, dtype=out.dtype)
        return out

    def _oracle(self, op, args, kwargs):
        return op.bound(*args, backend="torch", **kwargs)(*args)

    # -- sentinels -------------------------------------------------------
    def _sentinel(self, op, args, out) -> None:
        cfg = self.config
        fn = _SENTINELS.get(op.name)
        if fn is None or not cfg.sentinels:
            return
        fraction, detail = fn(args, out)
        self.metrics.sentinel_checks += 1
        self.metrics.max_saturation_fraction = max(
            self.metrics.max_saturation_fraction, fraction
        )
        if fraction > cfg.saturation_threshold:
            self.metrics.saturation_events += 1
            raise SaturationError(op.name, _dtype_name(out.dtype), fraction,
                                  detail, cfg.saturation_threshold)

    # -- the dispatch weave (called from KernelOp.__call__) --------------
    def guarded_call(self, op, args, kwargs, backend: str, mode: str):
        cfg, m = self.config, self.metrics
        name = op.name
        on_card = _on_card(args)
        self.clock += 1
        br = self.breakers.get(name)
        if br is not None and br.state == BREAKER_OPEN:
            if self.clock - br.opened_at >= self._cooldown_ticks(br):
                br.state = BREAKER_HALF_OPEN
                br.probe_ok = 0
                m.half_opens += 1
            elif self.serves_oracle(name, on_card):
                m.degraded_calls += 1
                return self._oracle(op, args, kwargs)
        half_open = br is not None and br.state == BREAKER_HALF_OPEN
        self._calls[name] = self._calls.get(name, 0) + 1
        check = (
            half_open
            or mode == "shadow"
            or (self._calls[name] + cfg.seed) % cfg.sample_stride == 0
        )
        try:
            out = self._run_native(op, args, kwargs, backend)
        except Exception as err:
            m.faults += 1
            injected = name in self._fault_injections
            self.trip(name, f"fault: {err!r}", injected)
            if not cfg.degrade or (on_card and not injected):
                raise  # on the card a real kernel failure is never masked
            warnings.warn(
                f"kernel op {name!r} quarantined to the torch backend after a "
                f"native-path failure: {err!r}",
                RuntimeWarning,
                stacklevel=4,
            )
            m.degraded_calls += 1
            return self._oracle(op, args, kwargs)
        self._sentinel(op, args, out)
        if not check:
            return out
        want = self._oracle(op, args, kwargs)
        tol = tolerance(out.dtype, hw=cfg.hw)
        report = compare(out, want, tol, op=name, backend=backend)
        m.checks += 1
        if report.ok:
            if half_open:
                br.probe_ok += 1
                if br.probe_ok >= cfg.probe_checks:
                    self.close(name)
            return out
        m.drift_events += 1
        injected = name in self._drift_injections
        self.trip(name, f"drift: max_ulp={report.max_ulp:.1f}", injected)
        if cfg.on_drift == "oracle" and (injected or not on_card):
            warnings.warn(
                f"kernel op {name!r} quarantined to the torch backend after "
                f"drift ({report.describe()})",
                RuntimeWarning,
                stacklevel=4,
            )
            m.degraded_calls += 1
            return want
        raise KernelDriftError(report)

    # -- canonical probes ------------------------------------------------
    def _probe_inputs(self, op_name: str, device: torch.device):
        key = (op_name, str(device))
        if key not in self._probe_cache:
            self._probe_cache[key] = _PROBES[op_name](device)
        return self._probe_cache[key]

    def probe_report(self, op_name: str) -> DriftReport:
        """One canonical native-vs-oracle check of ``op_name``, bypassing
        the breaker (this *is* the half-open probe).  Injections apply, so
        an injected fault/drift is attributable.  The probe runs on
        :func:`probe_device` with that device's native backend."""
        from repro_torch.kernels import api  # lazy: api imports this module

        op = api.get_op(op_name)
        device = probe_device()
        backend = api.default_backend(device)
        args, kwargs = self._probe_inputs(op_name, device)
        tol_dtype = args[0].dtype
        try:
            out = self._run_native(op, args, kwargs, backend)
        except Exception as err:
            self.metrics.checks += 1
            self.metrics.faults += 1
            tol = tolerance(tol_dtype, hw=self.config.hw)
            return DriftReport(op=op_name, backend=backend, shapes=(),
                               dtype=tol.dtype, ok=False, max_abs=float("inf"),
                               max_rel=float("inf"), max_ulp=float("inf"),
                               checked=0, tol=tol, error=repr(err))
        want = self._oracle(op, args, kwargs)
        tol = tolerance(out.dtype, hw=self.config.hw)
        report = compare(out, want, tol, op=op_name, backend=backend)
        self.metrics.checks += 1
        if not report.ok:
            self.metrics.drift_events += 1
        return report


_STATE = GuardState()


def state() -> GuardState:
    return _STATE


def reset(config: Optional[GuardConfig] = None) -> GuardState:
    """Replace the global guard state (breakers, metrics, injections)."""
    global _STATE
    _STATE = GuardState(config)
    return _STATE


def configure(**overrides) -> GuardConfig:
    """Update the active :class:`GuardConfig` in place (state/metrics and
    breakers survive — use :func:`reset` for a clean slate)."""
    _STATE.config = replace(_STATE.config, **overrides)
    return _STATE.config


@contextmanager
def isolated(config: Optional[GuardConfig] = None):
    """Scoped fresh guard state: runs that *intentionally* inject faults
    go inside this so their detections do not pollute an outer clean-run
    gate (``repro_torch.bench run --guard``)."""
    global _STATE
    prev = _STATE
    _STATE = GuardState(config)
    try:
        yield _STATE
    finally:
        _STATE = prev


def metrics() -> GuardMetrics:
    return _STATE.metrics


def _on_card(args) -> bool:
    """True when ``args`` hold a CUDA tensor."""
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in _leaves(args))


def tracing(args) -> bool:
    """True while a CUDA graph is being captured on the current stream and
    ``args`` hold CUDA tensors: no result can be read back mid-capture, so
    guarded checks skip there (the quarantine *routing* still applies)."""
    return _on_card(args) and torch.cuda.is_current_stream_capturing()


def serves_oracle(op_name: str, args) -> bool:
    """Whether a call of ``op_name`` on ``args`` routes to the oracle (its
    breaker is open); raises :class:`KernelGuardError` for CUDA tensors when
    the op was quarantined for a real failure."""
    return _STATE.serves_oracle(op_name, _on_card(args))


def is_quarantined(op_name: str) -> bool:
    """True while the op's breaker is open (calls route to the oracle)."""
    br = _STATE.breakers.get(op_name)
    return br is not None and br.state == BREAKER_OPEN


def quarantined_ops() -> tuple:
    return tuple(sorted(n for n in _STATE.breakers if is_quarantined(n)))


def quarantine(op_name: str, reason: str = "external", *, injected: bool = False) -> None:
    """Trip an op's breaker without raising (the engine's attribution path).
    ``injected`` marks a trip caused by the chaos surface: only such a
    quarantine lets the oracle serve the op's calls on CUDA tensors."""
    _STATE.trip(op_name, reason, injected)


def revive(op_name: str) -> None:
    """Close an op's breaker (counts a revival if it was open)."""
    _STATE.close(op_name)


def probe(op_name: str) -> bool:
    """Half-open re-probe: canonical native-vs-oracle check of a quarantined
    op.  Ops without a registered probe revive optimistically once no chaos
    injection targets them (breaker-standard: let one through; a recurrence
    re-trips with doubled cooldown)."""
    if op_name not in probe_ops():
        return not has_injection(op_name)
    return _STATE.probe_report(op_name).ok


def verify_ops(ops: Optional[list] = None) -> dict:
    """Shadow-verify every probe-registered op once (``op -> DriftReport``).

    This is the clean-run gate behind ``repro_torch.bench run --guard``: a
    non-empty set of failing reports on an uninjected run means the native
    kernels drifted from their oracles.
    """
    return {name: _STATE.probe_report(name) for name in (ops or probe_ops())}


def attribute(ops: Optional[list] = None) -> list:
    """Attribute a failure to specific kernel ops: probe each (non-open) op
    and quarantine + return the ones that fault or drift.  An empty list
    means no kernel op is implicated (the caller falls back to its own
    coarser degradation)."""
    bad = []
    for name in (ops or probe_ops()):
        if is_quarantined(name):
            continue
        report = _STATE.probe_report(name)
        if not report.ok:
            _STATE.trip(name, f"attributed: {report.describe()}", has_injection(name))
            bad.append(name)
    return bad


# ---------------------------------------------------------------------------
# chaos injection surface
# ---------------------------------------------------------------------------
def inject_fault(op_name: str, message: str = "injected cuda kernel fault") -> None:
    """Make the op's native path raise ``RuntimeError(message)``."""
    _STATE._fault_injections[op_name] = message


def clear_fault(op_name: str) -> None:
    _STATE._fault_injections.pop(op_name, None)


def inject_drift(op_name: str, *, scale: float = 0.05, seed: int = 0) -> None:
    """Perturb the op's native output with seeded additive noise of relative
    magnitude ``scale`` (deterministic: the rng sequence replays under the
    same call order)."""
    _STATE._drift_injections[op_name] = {
        "scale": float(scale),
        "rng": np.random.default_rng(seed),
    }


def clear_drift(op_name: str) -> None:
    _STATE._drift_injections.pop(op_name, None)


def has_injection(op_name: str) -> bool:
    return (op_name in _STATE._fault_injections
            or op_name in _STATE._drift_injections)


def clear_injections() -> None:
    _STATE._fault_injections.clear()
    _STATE._drift_injections.clear()


__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "DriftReport",
    "GUARD_MODES",
    "GuardConfig",
    "GuardMetrics",
    "GuardState",
    "KernelDriftError",
    "KernelGuardError",
    "OpBreaker",
    "SaturationError",
    "Tolerance",
    "attribute",
    "clear_drift",
    "clear_fault",
    "clear_injections",
    "compare",
    "configure",
    "has_injection",
    "inject_drift",
    "inject_fault",
    "is_quarantined",
    "isolated",
    "metrics",
    "probe",
    "probe_device",
    "probe_ops",
    "quarantine",
    "quarantined_ops",
    "register_probe",
    "register_sentinel",
    "reset",
    "revive",
    "serves_oracle",
    "state",
    "tolerance",
    "tracing",
    "trees_match",
    "verify_ops",
]
