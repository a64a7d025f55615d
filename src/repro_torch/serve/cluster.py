"""Serving cluster: a data-parallel replica router over serving engines.

Port of ``repro.serve.cluster``.  :class:`ClusterRouter` owns ``n_replicas``
engines behind the same ``submit() -> Session`` API as a single engine.  A
pluggable :class:`RouterPolicy` picks the replica per request (least-loaded
by default; round-robin; prefix-affinity that follows registered shared
prefixes), per-replica :class:`~repro_torch.serve.metrics.EngineMetrics`
roll up into one :class:`~repro_torch.serve.metrics.ClusterMetrics` summary,
and :meth:`ClusterRouter.fail_replica` takes a replica out: the failed
engine drains, and every in-flight/queued session re-queues onto the
survivors with its generated output intact (the recompute-preemption
invariant makes the resume token-exact).

Device placement (:func:`replica_meshes`): with one device every replica
shares the model and one copy of the params there (each keeps its own KV
cache and slots), as the reference's replicas share arrays when the mesh is
``None``; over several CUDA devices each replica takes one device, wrapping
around, with a model built there and its own copy of the params.  Tensor
parallelism inside a replica (the reference's ``tp > 1`` meshes) needs a
process group per replica under one router (ROADMAP.md §1 item 11b); a
single tensor-parallel engine runs with ``EngineConfig.mesh``.

Replicas are built lazily on first use, so a model family the engine cannot
serve surfaces its typed :class:`~repro_torch.serve.engine.UnsupportedFamilyError`
at ``submit()`` time — the first call a caller actually makes — rather than
at router construction.

Health-driven failover: with ``ClusterConfig.health`` set, every cluster
tick beats per-replica heartbeats into :class:`repro_torch.ft.HeartbeatMonitor`
(clocked in *ticks*, not seconds, so detection is deterministic) and feeds
per-replica step times to :class:`repro_torch.ft.StragglerDetector` (the
paper's §4.5 throttle signature); a replica that stops beating — e.g. its
engine raised :class:`~repro_torch.serve.engine.ReplicaCrashed` — or drifts
into the throttle signature is failed over automatically, and a circuit
breaker half-opens it back in after an exponentially-growing cool-down.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Optional, Protocol, Sequence, runtime_checkable

import torch

from repro_torch.core.throttle import V5E_THROTTLE, ThrottleParams
from repro_torch.core.timing import NoCudaDeviceError
from repro_torch.ft import HeartbeatMonitor, StragglerDetector
from repro_torch.models.api import ModelApi, build_model

from .engine import EngineConfig, ReplicaCrashed, ServeEngine
from .metrics import ClusterMetrics
from .paging import SharedPrefix
from .session import Session


# ---------------------------------------------------------------------------
# device topology
# ---------------------------------------------------------------------------
def _visible_cuda_devices() -> list:
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is visible; pass devices=[torch.device('cpu')] to "
            "place the replicas on the host"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def replica_meshes(n_replicas: int, tp: int = 1, devices=None) -> list:
    """One placement per replica over the available devices.

    ``devices`` defaults to the visible CUDA devices.  With ``tp == 1`` on a
    single device the placements are ``None``: the replicas share the model
    and its params.  With ``tp == 1`` over several devices each replica gets
    one ``torch.device``, wrapping around when replicas outnumber devices.
    ``tp > 1`` (a tensor-parallel process group per replica under one
    router) raises ``NotImplementedError``.
    """
    if n_replicas < 1:
        raise ValueError("n_replicas must be >= 1")
    if tp < 1:
        raise ValueError("tp must be >= 1")
    devices = _visible_cuda_devices() if devices is None else [torch.device(d) for d in devices]
    if tp > len(devices):
        raise ValueError(
            f"tensor-parallel degree {tp} needs {tp} devices, "
            f"have {len(devices)}"
        )
    if tp > 1:
        raise NotImplementedError(
            f"tensor-parallel replicas (tp={tp}) need a process group per replica "
            "under one router (ROADMAP.md §1 item 11b); use tp=1, or one engine with "
            "EngineConfig.mesh"
        )
    if len(devices) == 1:
        return [None] * n_replicas
    return [devices[r % len(devices)] for r in range(n_replicas)]


def _indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card), so two
    spellings of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _params_to(tree, device: torch.device):
    """A copy of a params tree on ``device``."""
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------
# circuit-breaker states (per replica): CLOSED serves normally, OPEN is
# failed and unroutable, HALF_OPEN is probing its way back in after cool-down
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


@dataclass
class Replica:
    """One data-parallel member: an engine pinned to a device.

    ``mesh`` keeps the reference's field name: ``None`` when every replica
    shares the model's device, else the replica's ``torch.device``.
    """

    index: int
    engine: ServeEngine
    mesh: Optional[torch.device] = None
    alive: bool = True
    # circuit-breaker bookkeeping (driven by ClusterRouter when health
    # monitoring is on; a manual fail_replica still opens the breaker)
    breaker: str = BREAKER_CLOSED
    failed_at: int = -1  # cluster tick of the most recent failure
    fail_count: int = 0  # lifetime failures (doubles the cool-down)
    probe_ok: int = 0  # consecutive healthy half-open ticks
    work_ticks: int = 0  # successful steps with work (straggler warm-up gate)

    def load(self) -> int:
        """Routing load: occupied slots plus queued sessions."""
        active = sum(s is not None for s in self.engine.slots)
        return active + self.engine.scheduler.pending()

    def has_work(self) -> bool:
        return self.alive and self.engine.has_work()

    @property
    def name(self) -> str:
        """Worker id in the heartbeat/straggler monitors."""
        return f"r{self.index}"


# ---------------------------------------------------------------------------
# routing policies
# ---------------------------------------------------------------------------
@runtime_checkable
class RouterPolicy(Protocol):
    """Replica selection: which live replica serves the next request.

    ``place`` must return the index of an *alive* replica (the router
    guarantees at least one exists when it calls).  Policies may also
    implement two optional hooks the router invokes when present:
    ``note_prefix(tokens, index)`` after a shared prefix is registered on a
    replica, and ``forget_replica(index)`` when a replica fails.
    """

    def place(self, prompt: Sequence[int], priority: int,
              replicas: Sequence[Replica]) -> int:
        ...


class RoundRobinPolicy:
    """Cycle through live replicas in index order."""

    def __init__(self):
        self._next = 0

    def place(self, prompt, priority, replicas) -> int:
        for _ in range(len(replicas)):
            idx = self._next % len(replicas)
            self._next += 1
            if replicas[idx].alive:
                return idx
        raise RuntimeError("no live replicas")

    def __repr__(self):
        return "RoundRobinPolicy()"


class LeastLoadedPolicy:
    """Fewest occupied slots + queued sessions wins (ties: lowest index)."""

    def place(self, prompt, priority, replicas) -> int:
        live = [r for r in replicas if r.alive]
        if not live:
            raise RuntimeError("no live replicas")
        return min(live, key=lambda r: (r.load(), r.index)).index

    def __repr__(self):
        return f"{type(self).__name__}()"


class PrefixAffinityPolicy(LeastLoadedPolicy):
    """Follow shared prefixes: a prompt that extends a registered prefix
    routes to the replica holding that prefix's pages (longest match wins),
    so the copy-on-write fork actually fires instead of re-prefilling on a
    replica that never saw the prefix.  Everything else falls back to
    least-loaded."""

    def __init__(self):
        self._owners: dict = {}  # prefix token tuple -> replica index

    def note_prefix(self, tokens, index: int) -> None:
        self._owners[tuple(int(t) for t in tokens)] = index

    def forget_replica(self, index: int) -> None:
        self._owners = {t: i for t, i in self._owners.items() if i != index}

    def place(self, prompt, priority, replicas) -> int:
        prompt = tuple(int(t) for t in prompt)
        best, best_len = None, 0
        for tokens, idx in self._owners.items():
            if (len(tokens) > best_len and len(tokens) < len(prompt)
                    and prompt[: len(tokens)] == tokens
                    and replicas[idx].alive):
                best, best_len = idx, len(tokens)
        if best is not None:
            return best
        return super().place(prompt, priority, replicas)


ROUTERS = {
    "round_robin": RoundRobinPolicy,
    "least_loaded": LeastLoadedPolicy,
    "prefix_affinity": PrefixAffinityPolicy,
}


def register_router(name: str, policy: Optional[type] = None):
    """Register a :class:`RouterPolicy` factory under ``name``.

    Registered policies become reachable everywhere stock ones are — by
    name in :class:`ClusterConfig`, :func:`make_router`, and the
    ``launch/serve.py --router`` flag.  Usable directly or as a decorator::

        @register_router("sticky")
        class StickyPolicy: ...

        register_router("sticky2", StickyPolicy)

    ``name`` must be new (re-registering raises, so stock policies cannot be
    shadowed silently); the factory is called with no arguments.
    """

    def _register(cls):
        if name in ROUTERS:
            raise ValueError(
                f"router {name!r} already registered ({ROUTERS[name].__name__}); "
                "pick a new name"
            )
        ROUTERS[name] = cls
        return cls

    return _register if policy is None else _register(policy)


def make_router(name: str) -> RouterPolicy:
    try:
        return ROUTERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown router {name!r}; registered: {sorted(ROUTERS)}"
        ) from None


# ---------------------------------------------------------------------------
# cluster
# ---------------------------------------------------------------------------
#: rid stride per replica: engine-local rids stay unique cluster-wide.
_RID_STRIDE = 10**6


@dataclass(frozen=True)
class HealthConfig:
    """Knobs for health-driven failover (``ClusterConfig.health``).

    All horizons are in **cluster ticks** — the monitors run on the router's
    tick clock, so detection points are deterministic and fault schedules
    replay exactly (wall-clock enters only through the straggler detector's
    step-time ratios).

    - ``heartbeat_timeout`` — ticks without a beat before a replica is
      declared dead and failed over (a crashed engine stops beating).
    - ``straggler`` — enable throttle-signature straggler failover;
      ``throttle``/``utilization``/``margin``/``min_samples`` parameterize
      the :class:`repro_torch.ft.StragglerDetector` (§4.5 slowdown signature).
    - ``cooldown`` — ticks a failed replica's breaker stays OPEN before the
      first half-open probe; doubles per repeat failure (capped at
      ``2**max_cooldown_doublings``).
    - ``probe_ticks`` — consecutive healthy HALF_OPEN ticks before the
      breaker fully closes again.
    - ``warmup_ticks`` — per-replica working steps to skip before feeding
      the straggler detector: the first few ticks carry first-call costs
      that would otherwise read as a throttle signature.
    """

    heartbeat_timeout: int = 3
    straggler: bool = True
    throttle: ThrottleParams = V5E_THROTTLE
    utilization: float = 0.9
    margin: float = 0.25
    min_samples: int = 5
    cooldown: int = 8
    probe_ticks: int = 2
    max_cooldown_doublings: int = 4
    warmup_ticks: int = 5

    def __post_init__(self):
        if self.heartbeat_timeout < 1:
            raise ValueError("heartbeat_timeout must be >= 1 tick")
        if self.cooldown < 1:
            raise ValueError("cooldown must be >= 1 tick")
        if self.probe_ticks < 1:
            raise ValueError("probe_ticks must be >= 1")
        if not 0.0 <= self.margin <= 1.0:
            raise ValueError("margin must be in [0, 1]")
        if self.warmup_ticks < 0:
            raise ValueError("warmup_ticks must be >= 0")


@dataclass(frozen=True)
class ClusterConfig:
    """Cluster-level knobs wrapped around one :class:`EngineConfig`.

    ``engine`` is the per-replica template — its ``mesh`` must be unset
    (the cluster owns device placement, see :func:`replica_meshes`).
    ``devices`` limits the device pool (default: the visible CUDA devices,
    or the model's device when the model was built on the CPU).  ``health``
    turns on heartbeat/straggler monitoring with automatic failover and the
    circuit breaker (default off: detection thresholds are workload-relative
    and first-tick costs would need the warm-up pass the bench suites do).
    """

    engine: EngineConfig
    n_replicas: int = 1
    tp: int = 1  # tensor-parallel degree inside each replica (only 1 runs)
    router: str = "least_loaded"  # policy name used when none is injected
    devices: Optional[tuple] = None  # device pool (None: see the docstring)
    health: Optional[HealthConfig] = None  # None: manual fail_replica only

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.tp < 1:
            raise ValueError("tp must be >= 1")
        if self.router not in ROUTERS:
            raise ValueError(
                f"unknown router {self.router!r}; registered: {sorted(ROUTERS)}"
            )
        if self.engine.mesh is not None:
            raise ValueError(
                "ClusterConfig owns device placement; leave EngineConfig.mesh "
                "unset (set ClusterConfig.tp for tensor parallelism)"
            )


class ClusterRouter:
    """Data-parallel front door: N engine replicas behind one ``submit``.

    The router exposes the single-engine surface — ``submit`` /
    ``register_prefix`` / ``step`` / ``run`` / ``summary`` — and fans it out
    over replicas via the configured :class:`RouterPolicy`.  Replicas are
    constructed lazily on first use; an unservable model family therefore
    raises :class:`UnsupportedFamilyError` from ``submit()``, naming the
    family and the dense fallback.

    In-process, ``step()`` advances every live replica one tick (replicas
    step one after another, each waiting for its sampled tokens, so cluster
    wall-clock — not summed engine time — is the throughput denominator;
    :class:`ClusterMetrics` handles that).
    """

    def __init__(self, model: ModelApi, params, config: ClusterConfig,
                 policy: Optional[RouterPolicy] = None):
        self.model = model
        self.params = params
        self.cfg = config
        self.policy = policy if policy is not None else make_router(config.router)
        if not isinstance(self.policy, RouterPolicy):
            raise TypeError(
                f"policy {type(self.policy).__name__} does not implement "
                "the RouterPolicy protocol (place)"
            )
        self.replicas: list = []  # built lazily by _ensure_replicas
        self.metrics = ClusterMetrics()
        self._placement: dict = {}  # session rid -> replica index
        # health monitoring runs on the router's tick clock — deterministic
        # detection horizons regardless of wall-clock jitter
        self._tick = 0
        h = config.health
        self.monitor = HeartbeatMonitor(
            timeout_s=float(h.heartbeat_timeout if h else 0),
            clock=lambda: float(self._tick),
        ) if h else None
        self.detector = StragglerDetector(
            throttle=h.throttle, utilization=h.utilization,
            margin=h.margin, min_samples=h.min_samples,
        ) if h and h.straggler else None

    # -- lifecycle ---------------------------------------------------------
    def _devices(self) -> list:
        if self.cfg.devices is not None:
            return list(self.cfg.devices)
        if torch.device(self.model.device).type == "cpu":
            return [torch.device("cpu")]
        return _visible_cuda_devices()

    def _ensure_replicas(self) -> None:
        if self.replicas:
            return
        placements = replica_meshes(self.cfg.n_replicas, self.cfg.tp, self._devices())
        # one (model, params) per device: replicas on the model's own device
        # share its params, so none is copied or re-cast per replica
        home = _indexed(self.model.device)
        built = {home: (self.model, self.params)}
        for i, dev in enumerate(placements):
            key = home if dev is None else _indexed(dev)
            if key not in built:
                built[key] = (build_model(self.model.cfg, device=key),
                              _params_to(self.params, key))
            model, params = built[key]
            engine = ServeEngine(model, params, self.cfg.engine)
            engine._rid = i * _RID_STRIDE  # cluster-unique session rids
            self.replicas.append(Replica(index=i, engine=engine, mesh=dev))
            if self.monitor is not None:
                # seed a beat so a replica that crashes before its first
                # successful step still ages into dead_workers()
                self.monitor.beat(f"r{i}", self._tick)

    def _live(self) -> list:
        live = [r for r in self.replicas if r.alive]
        if not live:
            raise RuntimeError(
                "no live replicas (all failed); cannot place the request"
            )
        return live

    # -- the engine-shaped surface -----------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               on_token=None, deadline_s: Optional[float] = None) -> Session:
        """Route a request to a replica; returns its :class:`Session`."""
        self._ensure_replicas()  # UnsupportedFamilyError surfaces here
        self._live()
        idx = self.policy.place([int(t) for t in prompt], priority, self.replicas)
        if not self.replicas[idx].alive:
            raise RuntimeError(f"policy placed request on dead replica {idx}")
        session = self.replicas[idx].engine.submit(
            prompt, max_new_tokens, priority=priority, on_token=on_token,
            deadline_s=deadline_s,
        )
        self._placement[session.rid] = idx
        self.metrics.record_route()
        return session

    def register_prefix(self, tokens, replica: Optional[int] = None) -> SharedPrefix:
        """Register a shared prompt prefix on one replica (paged mode).

        The owning replica is ``replica`` when given, else the least-loaded
        live one.  Policies with a ``note_prefix`` hook (prefix-affinity)
        learn the placement so future matching prompts follow the pages.
        """
        self._ensure_replicas()
        if replica is None:
            live = self._live()
            replica = min(live, key=lambda r: (r.load(), r.index)).index
        elif not self.replicas[replica].alive:
            raise ValueError(f"replica {replica} is not alive")
        prefix = self.replicas[replica].engine.register_prefix(tokens)
        note = getattr(self.policy, "note_prefix", None)
        if note is not None:
            note(tokens, replica)
        return prefix

    def step(self) -> None:
        """One cluster tick: every live replica with work advances one step.

        With health monitoring on, this is also the detection loop: replicas
        that step successfully beat the heartbeat monitor and feed the
        straggler detector their (scale-dilated) step times; a replica whose
        engine raises :class:`ReplicaCrashed` misses its beat and is failed
        over once the heartbeat horizon passes; OPEN breakers cool down
        toward HALF_OPEN, and healthy HALF_OPEN probes re-close.  Without
        health monitoring a crashed engine's error propagates (the manual,
        pre-health behavior).
        """
        self._ensure_replicas()
        h = self.cfg.health
        if h:
            self._breaker_tick(h)
        for r in self.replicas:
            if not r.alive:
                continue
            try:
                if r.engine.crashed:
                    # surface without mutating engine state (step() would
                    # raise the same before doing any work)
                    raise ReplicaCrashed(
                        f"replica {r.index} crashed at cluster tick {self._tick}"
                    )
                if r.has_work():
                    r.engine.step()
                    r.work_ticks += 1
                    # skip the replica's first few working steps: first-call
                    # costs there would read as a throttle signature.  Same
                    # for mid-run re-binds (op quarantine/revival, backend
                    # degradation) and for replicas with ops quarantined to
                    # the oracle — their step times are not fleet-comparable
                    # and would skew the throttle median both ways.
                    if (self.detector is not None
                            and r.work_ticks > h.warmup_ticks
                            and not r.engine.last_step_recompiled
                            and not r.engine.op_quarantined):
                        self.detector.observe(r.name, r.engine.last_step_s)
            except ReplicaCrashed:
                if h is None:
                    raise
                # no beat this tick: the heartbeat horizon drives failover
                if r.breaker == BREAKER_HALF_OPEN:
                    self._auto_fail(r.index, "probe")
                continue
            if h:
                self.monitor.beat(r.name, self._tick)
                if r.breaker == BREAKER_HALF_OPEN:
                    r.probe_ok += 1
                    if r.probe_ok >= h.probe_ticks:
                        r.breaker = BREAKER_CLOSED
                        self.metrics.record_revival()
        if h:
            self._health_failover(h)
            self.metrics.record_liveness(
                sum(r.alive for r in self.replicas), len(self.replicas)
            )
        self._tick += 1

    # -- health-driven failover --------------------------------------------
    def _breaker_tick(self, h: HealthConfig) -> None:
        """OPEN -> HALF_OPEN once a failed replica's cool-down has elapsed."""
        for r in self.replicas:
            if r.alive or r.breaker != BREAKER_OPEN:
                continue
            cooldown = h.cooldown * 2 ** min(
                max(r.fail_count - 1, 0), h.max_cooldown_doublings
            )
            if self._tick - r.failed_at < cooldown:
                continue
            r.alive = True
            r.breaker = BREAKER_HALF_OPEN
            r.probe_ok = 0
            self.metrics.record_half_open()
            self.monitor.beat(r.name, self._tick)  # not instantly dead again
            # the revived engine still holds its registered prefixes — re-teach
            # prefix-affinity policies the placement forget_replica() dropped
            note = getattr(self.policy, "note_prefix", None)
            if note is not None:
                for tokens in getattr(r.engine, "_prefixes", {}):
                    note(tokens, r.index)

    def _health_failover(self, h: HealthConfig) -> None:
        """Fail over replicas the monitors flag (dead beats, stragglers)."""
        for name in self.monitor.dead_workers():
            idx = int(name[1:])
            if self.replicas[idx].alive:
                self._auto_fail(idx, "heartbeat")
        if self.detector is not None:
            for name, _inflation in self.detector.stragglers():
                idx = int(name[1:])
                if self.replicas[idx].alive:
                    self._auto_fail(idx, "straggler")

    def _auto_fail(self, index: int, reason: str) -> None:
        """Detected-failure response; skips (and counts) when ``index`` is
        the last live replica — killing it would lose the cluster."""
        live = [r for r in self.replicas if r.alive]
        if len(live) <= 1:
            self.metrics.record_failover_skipped()
            return
        self.fail_replica(index, reason=reason)

    def has_work(self) -> bool:
        return any(r.has_work() for r in self.replicas)

    def run(self, max_ticks: int = 10_000) -> list:
        """Drive until every replica drains (or ``max_ticks``); returns the
        cluster-wide finished list.  Router wall-clock accumulates into
        ``ClusterMetrics.wall_s`` — the throughput denominator.  Exhausting
        the tick budget with work pending warns and bumps the
        ``tick_budget_exhausted`` counter (mirrors ``ServeEngine.run``)."""
        self._ensure_replicas()
        t0 = time.perf_counter()
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            self.step()
            ticks += 1
        self.metrics.wall_s += time.perf_counter() - t0
        if self.has_work():
            self.metrics.record_tick_budget_exhausted()
            warnings.warn(
                f"cluster run(max_ticks={max_ticks}) stopped with work still "
                f"pending on {sum(r.has_work() for r in self.replicas)} "
                "replica(s)",
                RuntimeWarning,
                stacklevel=2,
            )
        return self.finished

    @property
    def finished(self) -> list:
        return [s for r in self.replicas for s in r.engine.finished]

    # -- failure path ------------------------------------------------------
    def fail_replica(self, index: int, *, reason: str = "manual") -> list:
        """Take replica ``index`` out (manually or via health detection):
        drain it and requeue its live sessions onto the survivors.

        Every in-flight and queued session comes off the failed engine with
        its generated output intact; re-admission on the target replica
        replays prompt+output through prefill, so streams resume token-exact
        (each session keeps its ``Session`` handle — callers notice nothing
        but latency).  Requeues run through the target engine's budgeted
        :meth:`~repro_torch.serve.engine.ServeEngine.requeue` (a session
        bounced too often raises the typed ``RetryBudgetExceeded``).  The
        replica's circuit breaker opens; with health monitoring on it will
        half-open back in after the cool-down.  ``reason`` tags the failover
        counter (``manual`` / ``heartbeat`` / ``straggler`` / ``probe``).
        Returns the requeued sessions.
        """
        self._ensure_replicas()
        failed = self.replicas[index]
        if not failed.alive:
            raise ValueError(f"replica {index} already failed")
        failed.alive = False
        failed.breaker = BREAKER_OPEN
        failed.failed_at = self._tick
        failed.fail_count += 1
        if self.monitor is not None:
            self.monitor.forget(failed.name)
        if self.detector is not None:
            self.detector.forget(failed.name)
        drained = failed.engine.drain()
        self.metrics.record_failure(drained, reason=reason)
        forget = getattr(self.policy, "forget_replica", None)
        if forget is not None:
            forget(index)
        self._live()  # raises if nobody is left to take the load
        for session in drained:
            idx = self.policy.place(session.prompt, session.priority, self.replicas)
            target = self.replicas[idx].engine
            # requeue (not engine.submit) keeps the Session object and its
            # partial output alive, and charges the session's retry budget
            target.requeue(session)
            self._placement[session.rid] = idx
        return drained

    # -- telemetry ---------------------------------------------------------
    def _parts(self) -> list:
        return [r.engine.metrics for r in self.replicas]

    def summary(self) -> dict:
        """Cluster roll-up plus a ``per_replica`` breakdown."""
        self._ensure_replicas()
        out = self.metrics.summary(self._parts())
        out["tp"] = self.cfg.tp
        out["per_replica"] = [
            {"replica": r.index, "alive": r.alive, "breaker": r.breaker,
             **r.engine.summary()}
            for r in self.replicas
        ]
        return out

    def to_records(self, benchmark: str, prefix: str, x=None) -> list:
        self._ensure_replicas()
        return self.metrics.to_records(self._parts(), benchmark, prefix, x=x)

    def reset_metrics(self) -> None:
        """Fresh telemetry on every replica and the router (post-warm-up)."""
        for r in self.replicas:
            r.engine.reset_metrics()
        self.metrics = ClusterMetrics()
