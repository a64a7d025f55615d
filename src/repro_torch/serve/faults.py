"""Deterministic fault injection for the serving stack (chaos testing).

Port of ``repro.serve.faults`` (host code, ported whole): the same fault
kinds, the same seeded plans (``FaultPlan.random`` draws from numpy's
generator exactly as the reference does) and the same drive loop.

A :class:`FaultPlan` is a tick-addressed schedule of faults; a
:class:`FaultInjector` drives a :class:`~repro_torch.serve.engine.ServeEngine` or
:class:`~repro_torch.serve.cluster.ClusterRouter` tick by tick, applying each fault
at its scheduled tick and retiring it after its duration.  Everything is
derived from the plan (optionally seeded via :meth:`FaultPlan.random`), so a
chaos run is exactly reproducible: same plan + same workload seed -> same
tokens, same fault/retry/degradation counters.

Fault kinds and the engine surface they drive:

====================  =====================================================
kind                  effect while active
====================  =====================================================
``crash``             ``engine.crashed = True`` — ``step()`` raises
                      :class:`~repro_torch.serve.engine.ReplicaCrashed`; with
                      cluster health monitoring on, missed heartbeats fail
                      the replica over
``straggler``        ``engine.step_time_scale = factor`` — reported step
                      times dilate by the §4.5 throttle signature
                      (``core.throttle.slowdown_factor`` by default), which
                      the cluster's ``StragglerDetector`` flags; no real
                      sleeping, so chaos runs stay fast and deterministic
``kernel_fault``      the next step raises (simulated kernel build or
                      launch failure) — with ``op`` set the error carries
                      the kernel op's name and the numerics guard
                      quarantines *that op* to the oracle; without it the
                      engine degrades once to the ``torch`` backend (with
                      ``EngineConfig.degrade``); either way serving
                      continues token-identical
``kernel_drift``      the named ``op`` (default ``"matmul"``) starts
                      returning plausible-but-wrong values: seeded additive
                      noise of relative scale ``drift_scale`` perturbs the
                      replica's step logits, and the guard's global
                      injection surface perturbs the op's eager calls — the
                      shadow-oracle check detects it, attribution
                      quarantines the op, and output stays token-exact
``nan_logits``        the listed lanes' decode logits are poisoned with NaN
                      — the NaN guard quarantines the lane and retries the
                      session token-exact
``page_pressure``     steals free pages from the paged engine's pool
                      (held, then returned at expiry) — admission waits and
                      recompute preemption fire under real pressure
====================  =====================================================

One caveat: the ``kernel_drift``/op-targeted injections flow through
``repro_torch.kernels.guard``'s process-global state, so they are global across
replicas (the per-replica logits perturbation still honours ``replica``).

The injector never reaches into a kernel: every fault is a host-side flag
the hardened engine already honours, so injection composes with any
backend/scheduler combination.  An injected failure is the only kind the
engine and the guard let reach the oracle on the card (a real one raises).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.throttle import V5E_THROTTLE, ThrottleParams, slowdown_factor
from repro_torch.kernels import guard as kguard

from .cluster import ClusterRouter
from .engine import ReplicaCrashed, ServeEngine

# fault kinds
CRASH = "crash"
STRAGGLER = "straggler"
KERNEL_FAULT = "kernel_fault"
KERNEL_DRIFT = "kernel_drift"
NAN_LOGITS = "nan_logits"
PAGE_PRESSURE = "page_pressure"
KINDS = (CRASH, STRAGGLER, KERNEL_FAULT, KERNEL_DRIFT, NAN_LOGITS, PAGE_PRESSURE)
#: default draw set for :meth:`FaultPlan.random` — ``kernel_drift`` is
#: opt-in (pass ``kinds=KINDS``): undetected drift on a guard-off engine
#: corrupts tokens by design, which random chaos on arbitrary targets
#: (e.g. the serving launcher's --chaos) must not do
RANDOM_KINDS = (CRASH, STRAGGLER, KERNEL_FAULT, NAN_LOGITS, PAGE_PRESSURE)


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: ``kind`` hits ``replica`` at ``tick`` and stays
    active for ``duration`` injector ticks.

    ``factor`` (straggler) defaults to the throttle-signature slowdown;
    ``lanes`` (nan_logits) are the poisoned slot indices; ``pages``
    (page_pressure) is how many free pages to steal (clamped to what the
    pool has); ``message`` (kernel_fault) is the simulated error text;
    ``op`` names the kernel op a kernel_fault/kernel_drift targets
    (kernel_drift defaults to ``"matmul"``) and ``drift_scale`` is the
    relative magnitude of the injected drift noise.
    """

    tick: int
    kind: str
    replica: int = 0
    duration: int = 1
    factor: Optional[float] = None
    lanes: tuple = (0,)
    pages: int = 1
    message: str = "injected cuda kernel fault"
    op: Optional[str] = None  # kernel op targeted by kernel_fault/kernel_drift
    drift_scale: float = 0.05  # relative noise magnitude for kernel_drift

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected {KINDS}")
        if self.tick < 0:
            raise ValueError("fault tick must be >= 0")
        if self.duration < 1:
            raise ValueError("fault duration must be >= 1 tick")
        if self.replica < 0:
            raise ValueError("fault replica must be >= 0")
        if self.factor is not None and self.factor <= 1.0:
            raise ValueError("straggler factor must be > 1.0")
        if self.pages < 1:
            raise ValueError("page_pressure pages must be >= 1")
        if self.drift_scale <= 0:
            raise ValueError("drift_scale must be > 0")
        if self.kind == KERNEL_DRIFT and self.op is None:
            object.__setattr__(self, "op", "matmul")


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, tick-addressed fault schedule."""

    faults: tuple = ()
    seed: Optional[int] = None  # provenance when built by random()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    @classmethod
    def random(cls, seed: int, *, n_ticks: int = 32, n_faults: int = 4,
               n_replicas: int = 1, kinds: Sequence[str] = RANDOM_KINDS,
               max_duration: int = 4) -> "FaultPlan":
        """Seed-deterministic plan: ``n_faults`` draws over ``kinds`` with
        ticks in ``[1, n_ticks)`` — the same seed always yields the same
        schedule, so CI chaos runs are reproducible."""
        if n_ticks < 2:
            raise ValueError("n_ticks must be >= 2")
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            faults.append(Fault(
                tick=int(rng.integers(1, n_ticks)),
                kind=kind,
                replica=int(rng.integers(n_replicas)),
                duration=int(rng.integers(1, max_duration + 1)),
                lanes=(int(rng.integers(8)),),
                pages=int(rng.integers(1, 4)),
            ))
        return cls(faults=tuple(sorted(faults, key=lambda f: f.tick)), seed=seed)

    def at(self, tick: int) -> list:
        return [f for f in self.faults if f.tick == tick]

    @property
    def horizon(self) -> int:
        """First tick with every fault expired."""
        return max((f.tick + f.duration for f in self.faults), default=0)


class FaultInjector:
    """Applies a :class:`FaultPlan` against an engine or cluster while
    driving it tick by tick.

    The injector owns the drive loop (``step()`` / ``run()``): at each of
    its ticks it retires expired faults, applies newly-due ones, then steps
    the target once.  Fault state is *recomputed from the active set* every
    transition, so overlapping same-kind faults compose correctly (e.g. two
    crash windows on one replica keep it down until both pass).  A tick on
    which the target's engine is crashed still counts — the outage window
    passes, the fault expires, and serving resumes with zero lost sessions.
    """

    def __init__(self, plan: FaultPlan, target: Union[ServeEngine, ClusterRouter],
                 *, throttle: ThrottleParams = V5E_THROTTLE,
                 utilization: float = 0.9):
        self.plan = plan
        self.target = target
        self.tick = 0
        self.signature = slowdown_factor(throttle, utilization)
        self.counts: dict = {k: 0 for k in KINDS}  # applied, by kind
        self.skipped = 0  # faults that could not apply (e.g. pages on dense)
        self.crash_ticks = 0  # ticks the target refused to step
        self._active: list = []  # (expire_tick, fault, held_pages|None)
        self._drift_rngs: dict = {}  # id(fault) -> rng for its logits noise
        # kernel-op injections mirrored into the process-global guard state
        self._guard_drift_ops: set = set()
        self._guard_fault_ops: set = set()
        if any(f.replica >= self._n_replicas() for f in plan.faults):
            raise ValueError(
                f"plan targets replica >= {self._n_replicas()} but the "
                f"target has {self._n_replicas()} replica(s)"
            )

    # -- target introspection ------------------------------------------
    def _clustered(self) -> bool:
        return isinstance(self.target, ClusterRouter)

    def _n_replicas(self) -> int:
        return self.target.cfg.n_replicas if self._clustered() else 1

    def _engines(self) -> dict:
        """replica index -> engine (building cluster replicas if needed)."""
        if self._clustered():
            self.target._ensure_replicas()
            return {r.index: r.engine for r in self.target.replicas}
        return {0: self.target}

    # -- fault application ---------------------------------------------
    def _sync(self) -> None:
        """Recompute every engine's fault surface from the active set."""
        engines = self._engines()
        active = [f for _, f, _ in self._active]
        for idx, eng in engines.items():
            eng.crashed = any(
                f.kind == CRASH and f.replica == idx for f in active
            )
            factors = [
                f.factor if f.factor is not None else self.signature
                for f in active if f.kind == STRAGGLER and f.replica == idx
            ]
            eng.step_time_scale = max(factors) if factors else 1.0
            errs = [f for f in active
                    if f.kind == KERNEL_FAULT and f.replica == idx]
            err = RuntimeError(errs[-1].message) if errs else None
            if err is not None and errs[-1].op is not None:
                err.op = errs[-1].op  # attribution hint for the guard
            eng._inject_step_error = err
            eng._inject_nan_lanes = {
                lane for f in active if f.kind == NAN_LOGITS
                and f.replica == idx for lane in f.lanes
            }
            drifts = [f for f in active
                      if f.kind == KERNEL_DRIFT and f.replica == idx]
            eng._inject_drift = (
                {
                    "op": drifts[-1].op,
                    "scale": drifts[-1].drift_scale,
                    "rng": self._drift_rngs[id(drifts[-1])],
                }
                if drifts else None
            )
        # mirror op-targeted injections into the guard's global state so
        # eager guarded calls and attribution probes see them too (global
        # across replicas — see the module docstring caveat)
        drift_ops = {f.op for f in active if f.kind == KERNEL_DRIFT}
        fault_ops = {f.op for f in active if f.kind == KERNEL_FAULT
                     and f.op is not None}
        for op in drift_ops - self._guard_drift_ops:
            f = next(f for f in active if f.kind == KERNEL_DRIFT and f.op == op)
            kguard.inject_drift(op, scale=f.drift_scale,
                                seed=(self.plan.seed or 0) * 7919 + f.tick)
        for op in self._guard_drift_ops - drift_ops:
            kguard.clear_drift(op)
        for op in fault_ops - self._guard_fault_ops:
            f = next(f for f in active if f.kind == KERNEL_FAULT and f.op == op)
            kguard.inject_fault(op, f.message)
        for op in self._guard_fault_ops - fault_ops:
            kguard.clear_fault(op)
        self._guard_drift_ops = drift_ops
        self._guard_fault_ops = fault_ops

    def _apply(self, fault: Fault) -> None:
        engines = self._engines()
        eng = engines.get(fault.replica)
        if eng is None:
            self.skipped += 1
            return
        held = None
        if fault.kind == PAGE_PRESSURE:
            if not eng.paged or eng.allocator.free_pages == 0:
                self.skipped += 1
                return
            held = eng.allocator.alloc(
                min(fault.pages, eng.allocator.free_pages)
            )
        if fault.kind == KERNEL_DRIFT:
            # seeded per-fault rng: the same plan replays the same noise
            self._drift_rngs[id(fault)] = np.random.default_rng(
                (self.plan.seed or 0) * 7919 + fault.tick
            )
        self.counts[fault.kind] += 1
        self._active.append((self.tick + fault.duration, fault, held))
        self._sync()

    def _expire(self) -> None:
        due = [entry for entry in self._active if entry[0] <= self.tick]
        if not due:
            return
        self._active = [e for e in self._active if e[0] > self.tick]
        engines = self._engines()
        for _, fault, held in due:
            if held:  # return stolen pages to the pool
                engines[fault.replica].allocator.free(held)
            self._drift_rngs.pop(id(fault), None)
        self._sync()

    def expire_all(self) -> None:
        """Retire every active fault and restore the target's surface."""
        self.tick = max(self.tick, max((e[0] for e in self._active), default=0))
        self._expire()

    # -- drive loop -----------------------------------------------------
    def step(self) -> None:
        """One chaos tick: retire expired faults, apply due ones, step the
        target.  A crashed target (bare engine, or a cluster without health
        monitoring whose tick hit the crashed replica) does not step this
        tick — the outage window simply passes."""
        self._expire()
        for fault in self.plan.at(self.tick):
            self._apply(fault)
        try:
            self.target.step()
        except ReplicaCrashed:
            self.crash_ticks += 1
        self.tick += 1

    def run(self, max_ticks: int = 10_000) -> list:
        """Drive until the target drains and every fault has fired/expired
        (or ``max_ticks``); restores the fault surface before returning the
        target's finished list."""
        ticks = 0
        while ticks < max_ticks and (
            self.target.has_work()
            or self._active
            or self.tick < self.plan.horizon
        ):
            self.step()
            ticks += 1
        self.expire_all()
        return self.target.finished

    def summary(self) -> dict:
        """Injection-side counters (the serving-side ones live in
        ``EngineMetrics``/``ClusterMetrics``)."""
        return {
            "plan_faults": len(self.plan.faults),
            "applied": dict(self.counts),
            "skipped": self.skipped,
            "crash_ticks": self.crash_ticks,
            "ticks": self.tick,
        }
