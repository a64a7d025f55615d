"""A tensor-parallel serving replica: one engine over a group of ranks.

Port of what the reference's :class:`~repro.serve.cluster.ClusterRouter`
does with a replica's ``tp > 1`` mesh.  The reference's single controller
runs the replica's engine on a mesh of ``tp`` devices; here the replica is a
:class:`~repro_torch.dist.launcher.RankGroup` of ``tp`` ranks, and each rank
runs a :class:`~repro_torch.serve.engine.ServeEngine` on the replica's bound
1-D ``model`` mesh (params placed by ``dist.param_specs``, the KV cache by
``dist.cache_shardings``), with the same requests in the same order.  The
ranks sample the same tokens from the gathered logits; every tick the group
checks that they did.

:class:`TensorParallelReplica` is the caller's handle: it has the engine
surface the router, the fault injector and the cluster metrics read
(``submit``, ``step``, ``drain``, ``requeue``, ``register_prefix``,
``has_work``, ``slots``, ``scheduler``, ``finished``, ``last_step_s``,
``last_step_recompiled``, ``op_quarantined``, ``metrics``, ``summary``,
``reset_metrics``, ``_rid``, and the fault fields ``crashed``,
``step_time_scale``, ``_inject_step_error``, ``_inject_nan_lanes``,
``_inject_drift``, ``paged`` and ``allocator``).  Its :class:`Session`
objects live in the caller's process and are fed each tick's tokens from
the group's lead rank (rank 0); a drained session keeps its output, so a
requeue on another replica replays prompt + output and resumes
token-exact, as on an in-process engine.  Time-based decisions are the
caller's: a deadline is checked on the caller's clock before each tick and
sent to the ranks, so they agree on it.  ``last_step_s`` is the slowest
rank's step.

A rank that fails, or hangs past the group's timeout, fails the call and
closes the group.  The replica is then lost for good (``lost`` holds the
error): ``crashed`` stays set, and the call, and every later command,
raises :class:`~repro_torch.serve.engine.ReplicaCrashed`, so the router
fails it over as it does a crashed engine.  ``drain`` then returns the
caller's own sessions with their output as of the last tick that
reported; a session submitted or requeued to it meanwhile is held in the
caller's process until then.  ``metrics`` is the lead rank's, as of its
last report.  A crash flag (``crashed``) refuses the tick in the caller's
process before any rank runs it, as the in-process engine refuses.  The
kernel guard's op-level injections stay in the caller's process; the step
error, NaN lanes and logits drift a fault names reach the ranks.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Callable, Optional

from repro_torch.dist.launcher import RankGroup, rank_state, this_device

from .engine import EngineConfig, ReplicaCrashed, RetryBudgetExceeded, ServeEngine, check_request
from .metrics import EngineMetrics
from .session import QUEUED, Session

_STAT_FIELDS = ("admitted_at", "first_token_at", "finished_at", "preemptions", "requeues")


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------
def _snapshot(s: Session, sent: int) -> dict:
    """What changed on a session since ``sent`` of its tokens were reported."""
    return {"status": s.status, "finish_reason": s.finish_reason, "new": s.out[sent:],
            "new_times": s.stats.token_times[sent:],
            **{f: getattr(s.stats, f) for f in _STAT_FIELDS}}


def _report(rank: int, engine: ServeEngine, extra: Optional[dict] = None) -> dict:
    """This rank's engine state the caller mirrors: every tracked session's
    changes, the slots, the queue length, the sessions finished since the
    last report, the last step's timing and flags, and the lead rank's
    metrics."""
    st = rank_state()
    sessions, sent = st["sessions"], st["sent"]
    snaps = {rid: _snapshot(s, sent[rid]) for rid, s in sessions.items()}
    for rid, s in sessions.items():
        sent[rid] = len(s.out)
    finished = [s.rid for s in engine.finished[st["n_finished"]:]]
    st["n_finished"] = len(engine.finished)
    for rid in finished:  # done: the caller has its last state
        sessions.pop(rid, None)
        sent.pop(rid, None)
    out = {"sessions": snaps, "finished": finished,
           "slots": [None if s is None else s.rid for s in engine.slots],
           "pending": engine.scheduler.pending(), "last_step_s": engine.last_step_s,
           "last_step_recompiled": engine.last_step_recompiled,
           "op_quarantined": engine.op_quarantined,
           "free_pages": engine.allocator.free_pages if engine.paged else 0,
           "metrics": engine.metrics if rank == 0 else None}
    if extra:
        out.update(extra)
    return out


def _track(s: Session) -> None:
    st = rank_state()
    st["sessions"][s.rid] = s
    st["sent"][s.rid] = len(s.out)


def replica_start(rank: int, cfg, params, config: EngineConfig) -> dict:
    """Build this rank's engine: the model on the rank's device, ``params``
    (the global tree) placed on the replica's ``model`` mesh."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model

    dev = this_device()
    mesh = Mesh((tdist.get_world_size(),), ("model",)).bind(dev)
    engine = ServeEngine(build_model(cfg, device=dev), params, replace(config, mesh=mesh))
    del params  # the engine holds this rank's shards
    st = rank_state()
    st.clear()
    st.update(engine=engine, sessions={}, sent={}, n_finished=0, fault=None)
    return _report(rank, engine)


def _session(state: dict) -> Session:
    """A rank's copy of a caller's session (no deadline: the caller keeps
    the clock, and sends an expired one)."""
    s = Session(state["rid"], list(state["prompt"]), state["max_new_tokens"],
                priority=state["priority"], out=list(state["out"]))
    s._on_queued_cancel = rank_state()["engine"]._record_queued_cancel
    s.stats.submitted_at = state["submitted_at"]
    s.stats.token_times = list(state["token_times"])
    for f in _STAT_FIELDS:
        setattr(s.stats, f, state[f])
    return s


def _set_faults(engine: ServeEngine, fault: dict) -> None:
    """The fault surface the caller's fields give, set on this rank's
    engine (a step error made anew only when the caller's changes, so it
    stays one object while it is active)."""
    st = rank_state()
    engine.step_time_scale = fault["scale"]
    engine._inject_nan_lanes = set(fault["nan_lanes"])
    if fault["error"] != st["fault"]:
        st["fault"] = fault["error"]
        err = None
        if fault["error"] is not None:
            message, op = fault["error"]
            err = RuntimeError(message)
            if op is not None:
                err.op = op
        engine._inject_step_error = err
    engine._inject_drift = fault["drift"]


def replica_command(rank: int, op: str, *args) -> dict:
    """Run one engine operation on this rank's engine; the report after it."""
    st = rank_state()
    engine: ServeEngine = st["engine"]
    extra = {}
    if op == "submit":
        state = args[0]
        _track(_session(state))
        engine.scheduler.submit(st["sessions"][state["rid"]])
    elif op == "requeue":
        s = _session(args[0])
        s.status = QUEUED
        _track(s)
        try:
            engine.requeue(s)
        except RetryBudgetExceeded:
            extra["budget_exceeded"] = True
            st["sessions"].pop(s.rid)
            st["sent"].pop(s.rid)
    elif op == "step":
        fault, expired, cancelled = args
        _set_faults(engine, fault)
        for rid in expired:
            st["sessions"][rid].deadline_s = -1.0  # expired on the caller's clock
        for rid in cancelled:
            st["sessions"][rid].cancel()
        engine.step()
        if fault["drift"] is not None:  # the noise drawn this tick, for the caller's rng
            extra["drift_rng"] = fault["drift"]["rng"].bit_generator.state
    elif op == "cancel":
        st["sessions"][args[0]].cancel()
    elif op == "drain":
        drained = engine.drain()
        extra["drained"] = [s.rid for s in drained]
        report = _report(rank, engine, extra)
        for s in drained:  # they leave this replica with their output
            st["sessions"].pop(s.rid, None)
            st["sent"].pop(s.rid, None)
        return report
    elif op == "register_prefix":
        extra["prefix"] = engine.register_prefix(args[0])
    elif op == "alloc":
        extra["pages"] = engine.allocator.alloc(args[0])
    elif op == "free":
        engine.allocator.free(args[0])
    elif op == "reset_metrics":
        engine.reset_metrics()
        st["n_finished"] = 0
    else:
        raise ValueError(f"unknown replica command {op!r}")
    return _report(rank, engine, extra)


# ---------------------------------------------------------------------------
# the caller's side
# ---------------------------------------------------------------------------
class _Queue:
    """The group's queue length, as the router reads it."""

    def __init__(self):
        self.n = 0

    def pending(self) -> int:
        return self.n


class _Allocator:
    """The ranks' page pools, which move in lockstep (the page-pressure
    fault's surface)."""

    def __init__(self, replica: "TensorParallelReplica"):
        self._replica = replica
        self.free_pages = 0

    def alloc(self, n: int = 1) -> list:
        return self._replica._command("alloc", n)["pages"]

    def free(self, pages) -> None:
        self._replica._command("free", list(pages))


class TensorParallelReplica:
    """One serving replica over ``len(devices)`` ranks (see the module
    docstring).  ``cfg`` is the model's config and ``params`` its global
    params; ``devices`` gives each rank its device (ranks on one card share
    it over gloo)."""

    def __init__(self, cfg, params, config: EngineConfig, devices):
        self.cfg = config
        self.paged = config.page_size is not None
        self.n_pages = ((config.n_pages or config.n_slots * config.table_width)
                        if self.paged else 0)
        self.slots: list = [None] * config.n_slots
        self.scheduler = _Queue()
        self.allocator = _Allocator(self) if self.paged else None
        self.finished: list = []
        self.last_step_s = 0.0
        self.last_step_recompiled = False
        self.op_quarantined = False
        self._rid = 0
        self._sessions: dict = {}  # rid -> the caller's Session, while on this replica
        self._prefixes: dict = {}  # registered prefix tokens -> the lead rank's SharedPrefix
        self._metrics: Optional[EngineMetrics] = None  # the lead rank's, as last reported
        self.lost: Optional[BaseException] = None  # why the ranks are gone
        # fault surface, as on ServeEngine
        self._crashed = False
        self.step_time_scale = 1.0
        self._inject_step_error: Optional[Exception] = None
        self._inject_nan_lanes: set = set()
        self._inject_drift: Optional[dict] = None
        self.group = RankGroup(len(devices), devices=list(devices))
        try:
            reports = self.group.call(replica_start, cfg, params, config)
        except BaseException:
            self.group.close()
            raise
        self._mirror(reports)

    def close(self) -> None:
        """Stop the replica's ranks."""
        self.group.close()

    @property
    def crashed(self) -> bool:
        """The fault flag, and always set once the ranks are lost."""
        return self._crashed or self.lost is not None

    @crashed.setter
    def crashed(self, value: bool) -> None:
        self._crashed = value

    # -- mirroring ---------------------------------------------------------
    def _command(self, op: str, *args) -> dict:
        """Run ``op`` on every rank and mirror the reports; a failed call
        loses the replica (see the module docstring)."""
        if self.lost is None:
            closed = self.group.closed  # by the caller: its own error stands
            try:
                reports = self.group.call(replica_command, op, *args)
            except (RuntimeError, TimeoutError) as e:
                if closed or not self.group.closed:
                    raise
                self.lost = e
            else:
                self._mirror(reports)
                return reports[0]
        raise ReplicaCrashed(f"tensor-parallel replica: its ranks are gone "
                             f"({type(self.lost).__name__})") from self.lost

    def _hold(self, s: Session) -> None:
        """Keep ``s`` queued in the caller's process, on a lost replica,
        until :meth:`drain` hands it on."""
        s.status = QUEUED
        self.scheduler.n += 1

    def _mirror(self, reports: list) -> None:
        """Take the lead rank's report into the caller's sessions, after
        checking that every rank holds the same token streams."""
        lead = reports[0]
        for i, r in enumerate(reports[1:], 1):
            if ({k: (v["status"], v["new"]) for k, v in r["sessions"].items()}
                    != {k: (v["status"], v["new"]) for k, v in lead["sessions"].items()}
                    or r["slots"] != lead["slots"]):
                raise RuntimeError(f"tensor-parallel replica: rank {i} diverged from rank 0")
        for rid, snap in lead["sessions"].items():
            s = self._sessions[rid]
            for tok, t in zip(snap["new"], snap["new_times"]):
                s.out.append(int(tok))
                s.stats.token_times.append(t)
                if s.on_token is not None:
                    s.on_token(s, int(tok))
            s.status, s.finish_reason = snap["status"], snap["finish_reason"]
            for f in _STAT_FIELDS:
                setattr(s.stats, f, snap[f])
        for rid in lead["finished"]:
            self.finished.append(self._sessions.pop(rid))
        self.slots = [None if rid is None else self._sessions[rid] for rid in lead["slots"]]
        self.scheduler.n = lead["pending"]
        self._metrics = lead["metrics"]
        self.last_step_s = max(r["last_step_s"] for r in reports)
        self.last_step_recompiled = any(r["last_step_recompiled"] for r in reports)
        self.op_quarantined = any(r["op_quarantined"] for r in reports)
        if self.allocator is not None:
            self.allocator.free_pages = lead["free_pages"]

    def _state(self, s: Session) -> dict:
        return {"rid": s.rid, "prompt": s.prompt, "max_new_tokens": s.max_new_tokens,
                "priority": s.priority, "out": s.out, "submitted_at": s.stats.submitted_at,
                "token_times": s.stats.token_times,
                **{f: getattr(s.stats, f) for f in _STAT_FIELDS}}

    def _track(self, s: Session) -> None:
        self._sessions[s.rid] = s
        s._on_queued_cancel = self._queued_cancel

    def _queued_cancel(self, s: Session) -> None:
        try:
            self._command("cancel", s.rid)
        except ReplicaCrashed:  # as the engine records a queued cancel
            self._sessions.pop(s.rid, None)
            self.scheduler.n -= 1
            self._metrics.record_finished(s)
            self.finished.append(s)

    # -- the engine surface ------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               on_token: Optional[Callable] = None,
               deadline_s: Optional[float] = None) -> Session:
        prompt = check_request(self.cfg, prompt, max_new_tokens, deadline_s)
        s = Session(self._rid, prompt, max_new_tokens, priority=priority, on_token=on_token,
                    deadline_s=deadline_s)
        s.stats.submitted_at = time.perf_counter()
        self._rid += 1
        self._track(s)
        try:
            self._command("submit", self._state(s))
        except ReplicaCrashed:
            self._hold(s)
        return s

    def requeue(self, session: Session) -> None:
        self._track(session)
        session.status = QUEUED
        try:
            report = self._command("requeue", self._state(session))
        except ReplicaCrashed:
            self._hold(session)
            return
        if report.get("budget_exceeded"):
            self._sessions.pop(session.rid, None)
            raise RetryBudgetExceeded(session, self.cfg.retry_budget)

    def step(self) -> None:
        if self._crashed:
            raise ReplicaCrashed("engine is crashed (fault-injected)")
        now = time.perf_counter()
        live = [s for s in self._sessions.values() if not s.done]
        expired = [s.rid for s in live if s.deadline_expired(now)]
        cancelled = [s.rid for s in live if s.cancel_requested]
        err = self._inject_step_error
        fault = {"scale": self.step_time_scale, "nan_lanes": sorted(self._inject_nan_lanes),
                 "error": None if err is None else (str(err), getattr(err, "op", None)),
                 "drift": self._inject_drift}
        report = self._command("step", fault, expired, cancelled)
        if self._inject_drift is not None:
            self._inject_drift["rng"].bit_generator.state = report["drift_rng"]

    def drain(self) -> list:
        try:
            drained = [self._sessions.pop(rid) for rid in self._command("drain")["drained"]]
        except ReplicaCrashed:  # the caller's own sessions, as the engine drains its own
            running = [s for s in self.slots if s is not None]
            lanes = {s.rid for s in running}
            drained = running + [s for s in self._sessions.values()
                                 if not s.done and s.rid not in lanes]
            for s in drained:
                s.status = QUEUED
            for s in running:
                s.stats.preemptions += 1
            self._sessions = {}
        self.slots = [None] * self.cfg.n_slots
        self.scheduler.n = 0
        return drained

    def register_prefix(self, tokens):
        prefix = self._command("register_prefix", [int(t) for t in tokens])["prefix"]
        self._prefixes[tuple(int(t) for t in tokens)] = prefix
        return prefix

    def has_work(self) -> bool:
        return any(s is not None for s in self.slots) or self.scheduler.pending() > 0

    @property
    def metrics(self) -> EngineMetrics:
        """The lead rank's :class:`~repro_torch.serve.metrics.EngineMetrics`,
        as of its last report."""
        return self._metrics

    def summary(self) -> dict:
        return self.metrics.summary()

    def reset_metrics(self) -> None:
        try:
            self._command("reset_metrics")
        except ReplicaCrashed:
            self._metrics = EngineMetrics(self.cfg.n_slots, n_pages=self.n_pages)
        self.finished = []
