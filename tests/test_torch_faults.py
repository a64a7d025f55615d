"""The port's chaos layer and health failover against the reference's on the CPU.

The cases of ``tests/test_faults.py``, each run through ``repro.serve`` and
``repro_torch.serve`` on gemma-2b reduced (the reference's weights carried
across by ``params_from_jax``) with the same numpy-seeded prompts: fault and
plan validation, ``FaultPlan.random`` drawing identical plans in both
packages, every fault kind (crash, straggler, kernel_fault with and without
an op, kernel_drift, nan_logits, page_pressure), heartbeat and straggler
failover with the circuit breaker, deadlines, the retry budget and backoff,
degradation and the tick budget — tokens and counters equal to the
reference's.  Then ``serving_chaos``'s two fixed plans through both
packages' clusters, the guarded legs included, and both serving suites'
record names.

Backends map ``pallas`` -> ``cuda`` and ``xla`` -> ``torch``.  The port's
``EngineConfig.degrade`` defaults off (the reference's on), so the port's
engines here set it as the reference's default has it.  On the CPU the
port's ``cuda`` engines run their steps (plain torch) under the ``cuda``
policy, as ``tests/test_torch_serve.py`` does.  Straggler detection reads
wall-clock step times; the ``steady_clock`` fixture makes every engine of
both packages report one fixed step time (times its straggler dilation), so
the injected 4x straggler drives the same detections in both and every
counter compares exactly.  A run on real clocks compares tokens only.
"""
import warnings

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import serve as jserve
from repro.bench import runner as jrunner
from repro.bench.suites import serving_chaos as jchaos
from repro.core import registry as jregistry
from repro.kernels import guard as jguard
from repro.models import build_model as jbuild
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.bench import runner as trunner
from repro_torch.bench.suites import serving_chaos as tchaos
from repro_torch.core import registry as tregistry
from repro_torch.kernels import guard as tguard
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as tengine
from repro_torch.serve.cluster import BREAKER_CLOSED, BREAKER_OPEN

NATIVE = {jserve: "pallas", tserve: "cuda"}
ORACLE = {jserve: "xla", tserve: "torch"}


@pytest.fixture(scope="module")
def gemma():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return {"jax": (jserve, jcfg, jmodel, jparams),
            "torch": (tserve, tcfg, tbuild(tcfg, device="cpu"), tparams)}


@pytest.fixture(autouse=True)
def _fresh_guards():
    with jguard.isolated(), tguard.isolated():
        yield


@pytest.fixture
def steady_clock(monkeypatch):
    for cls in (jengine.ServeEngine, tengine.ServeEngine):
        real = cls.step

        def step(self, _real=real):
            _real(self)
            self.last_step_s = 0.01 * self.step_time_scale

        monkeypatch.setattr(cls, "step", step)


def _both(gemma, drive):
    return drive(*gemma["jax"]), drive(*gemma["torch"])


def _prompts(cfg, n, lens=(3, 5, 4), seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, lens[i % len(lens)])]
            for i in range(n)]


def _ecfg(serve, **kw):
    """An EngineConfig of ``serve`` at the reference tests' sizes; a ``backend``
    of "native"/"oracle" maps to the package's name, and the port degrades
    as the reference's default does unless told otherwise."""
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("prefill_chunk", 4)
    if kw.get("backend") in ("native", "oracle"):
        kw["backend"] = (NATIVE if kw["backend"] == "native" else ORACLE)[serve]
    if serve is tserve:
        kw.setdefault("degrade", True)
    return serve.EngineConfig(**kw)


def _engine(serve, model, params, **kw):
    kw.setdefault("backend", "oracle")
    return serve.ServeEngine(model, params, _ecfg(serve, **kw))


def _single_engine_outputs(serve, model, params, prompts, max_new=8, **kw):
    engine = serve.ServeEngine(model, params, _ecfg(serve, **kw))
    sessions = [engine.submit(p, max_new) for p in prompts]
    engine.run()
    return {tuple(p): s.out for p, s in zip(prompts, sessions)}


#: summary() keys that do not read a clock
TIMED = {"total_s", "throughput_tok_s", "prefill_tok_s", "ttft_ms_mean", "ttft_ms_p50",
         "ttft_ms_p95", "tok_latency_ms_p50", "tok_latency_ms_p95", "goodput_tok_s"}


def _counters(summary: dict) -> dict:
    out = {k: v for k, v in summary.items() if k not in TIMED | {"per_replica"}}
    out["per_replica"] = [{k: v for k, v in r.items() if k not in TIMED}
                          for r in summary.get("per_replica", [])]
    return out


def _plan_fields(plan):
    """A plan's faults without the simulated error text (each package names
    its own kernel route there)."""
    return [(f.tick, f.kind, f.replica, f.duration, f.factor, f.lanes, f.pages, f.op,
             f.drift_scale) for f in plan.faults], plan.seed, plan.horizon


# ---------------------------------------------------------------------------
# FaultPlan / Fault (unit, no engines)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,match", [
    (dict(tick=0, kind="meteor"), "unknown fault kind"),
    (dict(tick=0, kind="crash", duration=0), "duration"),
    (dict(tick=0, kind="straggler", factor=1.0), "factor"),
    (dict(tick=-1, kind="crash"), "tick"),
    (dict(tick=0, kind="crash", replica=-1), "replica"),
    (dict(tick=0, kind="page_pressure", pages=0), "pages"),
    (dict(tick=0, kind="kernel_drift", drift_scale=0.0), "drift_scale"),
])
def test_fault_validation(kw, match):
    for serve in (tserve, jserve):
        with pytest.raises(ValueError, match=match):
            serve.Fault(**kw)
    assert tserve.Fault(tick=0, kind="kernel_drift").op == "matmul"  # the default op


@pytest.mark.parametrize("seed,kw", [
    (7, dict(n_ticks=16, n_faults=5, n_replicas=3)),
    (8, dict(n_ticks=16, n_faults=5)),
    (7, dict(n_faults=4, n_replicas=2)),  # the serving launcher's --chaos drill
    (11, dict(n_ticks=64, n_faults=12, n_replicas=4, max_duration=8)),
    (3, dict(n_faults=6, kinds=tserve.faults.KINDS)),
])
def test_fault_plan_random_is_the_references_plan(seed, kw):
    a = tserve.FaultPlan.random(seed, **kw)
    assert a == tserve.FaultPlan.random(seed, **kw) and a.seed == seed
    assert _plan_fields(a) == _plan_fields(jserve.FaultPlan.random(seed, **kw))
    ticks = [f.tick for f in a.faults]
    assert ticks == sorted(ticks) and all(1 <= t < kw.get("n_ticks", 32) for t in ticks)
    assert a.horizon == max(f.tick + f.duration for f in a.faults)
    assert a.at(ticks[0]) and not a.at(-1)
    with pytest.raises(ValueError, match="n_ticks"):
        tserve.FaultPlan.random(seed, n_ticks=1)


def test_injector_rejects_out_of_range_replica(gemma):
    for serve, _, model, params in gemma.values():
        engine = _engine(serve, model, params)
        plan = serve.FaultPlan(faults=(serve.Fault(tick=1, kind="crash", replica=3),))
        with pytest.raises(ValueError, match="replica"):
            serve.FaultInjector(plan, engine)


# ---------------------------------------------------------------------------
# the acceptance criterion: scripted chaos, deterministic, zero loss
# ---------------------------------------------------------------------------
def _scripted_plan(serve):
    return serve.FaultPlan(faults=(
        serve.Fault(tick=2, kind="crash", replica=0, duration=4),  # replica crash @ N
        serve.Fault(tick=3, kind="straggler", replica=1, duration=3, factor=4.0),
        serve.Fault(tick=6, kind="kernel_fault", replica=1),  # one kernel-style fault
        serve.Fault(tick=7, kind="nan_logits", replica=1, lanes=(0,), duration=1),
    ))


def test_scripted_chaos_zero_loss_token_exact_deterministic(gemma, steady_clock):
    def run(serve, cfg, model, params):
        prompts = _prompts(cfg, 6, seed=3)
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=_ecfg(serve, backend="oracle", page_size=4), n_replicas=2,
            router="round_robin",
            health=serve.HealthConfig(heartbeat_timeout=2, min_samples=3, margin=0.25,
                                      cooldown=50)))
        sessions = [cluster.submit(p, 8) for p in prompts]
        injector = serve.FaultInjector(_scripted_plan(serve), cluster)
        injector.run()
        return cluster, sessions, injector

    def drive(serve, cfg, model, params):
        prompts = _prompts(cfg, 6, seed=3)
        ref = _single_engine_outputs(serve, model, params, prompts, page_size=4)
        cluster, sessions, injector = run(serve, cfg, model, params)
        assert len(cluster.finished) == len(prompts)  # zero lost sessions
        for p, s in zip(prompts, sessions):
            assert s.done and s.finish_reason != "deadline"
            assert s.out == ref[tuple(p)], ("chaos divergence", p)
        summ = cluster.summary()
        assert summ["failovers"], "the crash must have driven a failover"
        assert summ["requeues"] >= 1 and summ["quarantines"] == 1
        assert 0 < summ["availability"] < 1
        assert injector.summary()["applied"]["crash"] == 1
        # the whole run replays exactly: tokens AND counters
        cluster2, sessions2, injector2 = run(serve, cfg, model, params)
        assert [s.out for s in sessions2] == [s.out for s in sessions]
        assert _counters(cluster2.summary()) == _counters(summ)
        assert injector2.summary() == injector.summary()
        return [s.out for s in sessions], _counters(summ), injector.summary()

    j, t = _both(gemma, drive)
    assert t == j


# ---------------------------------------------------------------------------
# health-driven failover
# ---------------------------------------------------------------------------
def test_heartbeat_failover_on_crash(gemma):
    def drive(serve, cfg, model, params):
        prompts = _prompts(cfg, 4, seed=4)
        ref = _single_engine_outputs(serve, model, params, prompts)
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=_ecfg(serve, backend="oracle"), n_replicas=2, router="round_robin",
            health=serve.HealthConfig(heartbeat_timeout=2, straggler=False, cooldown=50)))
        sessions = [cluster.submit(p, 8) for p in prompts]
        plan = serve.FaultPlan(faults=(serve.Fault(tick=1, kind="crash", replica=0,
                                                   duration=30),))
        inj = serve.FaultInjector(plan, cluster)
        inj.run()
        assert cluster.summary()["failovers"] == {"heartbeat": 1}
        assert not cluster.replicas[0].alive
        assert cluster.replicas[0].breaker == BREAKER_OPEN  # cooldown > run length
        for p, s in zip(prompts, sessions):
            assert s.done and s.out == ref[tuple(p)]
        return [s.out for s in sessions], _counters(cluster.summary()), inj.summary()

    j, t = _both(gemma, drive)
    assert t == j


def test_straggler_failover_breaker_reopens_and_revives(gemma, steady_clock):
    def drive(serve, cfg, model, params):
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=_ecfg(serve, backend="oracle"), n_replicas=2, router="round_robin",
            health=serve.HealthConfig(heartbeat_timeout=3, min_samples=3, margin=0.25,
                                      cooldown=2, probe_ticks=2, warmup_ticks=2)))
        prompts = _prompts(cfg, 8, lens=(5,), seed=5)
        sessions = [cluster.submit(p, 16) for p in prompts]
        plan = serve.FaultPlan(faults=(serve.Fault(tick=1, kind="straggler", replica=1,
                                                   duration=8, factor=6.0),))
        serve.FaultInjector(plan, cluster).run()
        summ = cluster.summary()
        assert summ["failovers"].get("straggler", 0) >= 1
        # cooldown elapsed mid-run: the breaker half-opened and, with the fault
        # expired, probed healthy back to CLOSED
        assert summ["half_opens"] >= 1 and summ["revivals"] >= 1
        assert cluster.replicas[1].alive
        assert cluster.replicas[1].breaker == BREAKER_CLOSED
        assert all(s.done for s in sessions)
        return [s.out for s in sessions], _counters(summ)

    j, t = _both(gemma, drive)
    assert t == j


def test_last_replica_failover_is_skipped_not_fatal(gemma):
    def drive(serve, cfg, model, params):
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=_ecfg(serve, backend="oracle"), n_replicas=1,
            health=serve.HealthConfig(heartbeat_timeout=1, straggler=False, cooldown=3)))
        s = cluster.submit(_prompts(cfg, 1)[0], 6)
        plan = serve.FaultPlan(faults=(serve.Fault(tick=1, kind="crash", duration=4),))
        inj = serve.FaultInjector(plan, cluster)
        inj.run()
        # the only replica is never auto-killed; it resumes after the outage
        assert cluster.summary()["failover_skipped"] >= 1
        assert cluster.replicas[0].alive and s.done
        return s.out, _counters(cluster.summary()), inj.summary()

    j, t = _both(gemma, drive)
    assert t == j


def test_cluster_without_health_propagates_crash(gemma):
    for serve, cfg, model, params in gemma.values():
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=_ecfg(serve, backend="oracle"), n_replicas=1))
        cluster.submit(_prompts(cfg, 1)[0], 4)
        cluster._ensure_replicas()
        cluster.replicas[0].engine.crashed = True
        with pytest.raises(serve.ReplicaCrashed):
            cluster.step()
        # a bare engine driven by the injector sits the outage out
        engine = _engine(serve, model, params)
        s = engine.submit(_prompts(cfg, 1)[0], 4)
        inj = serve.FaultInjector(serve.FaultPlan(faults=(
            serve.Fault(tick=1, kind="crash", duration=3),)), engine)
        inj.run()
        assert s.done and inj.summary()["crash_ticks"] == 3 and not engine.crashed


# ---------------------------------------------------------------------------
# deadlines, retry budget, backoff
# ---------------------------------------------------------------------------
def test_deadline_unmeetable_vs_generous(gemma):
    def drive(serve, cfg, model, params):
        engine = _engine(serve, model, params)
        p1, p2 = _prompts(cfg, 2, seed=6)
        tight = engine.submit(p1, 8, deadline_s=1e-9)  # expires before any token
        loose = engine.submit(p2, 8, deadline_s=3600.0)
        finished = engine.run()
        assert len(finished) == 2
        assert tight.finish_reason == "deadline"
        assert loose.finish_reason == "max_new_tokens" and len(loose.out) == 8
        summ = engine.summary()
        assert summ["deadline_expired"] == 1
        assert summ["goodput_tokens"] == summ["generated_tokens"] - len(tight.out)
        with pytest.raises(ValueError, match="deadline_s"):
            engine.submit(p1, 4, deadline_s=0.0)
        return tight.out, loose.out, _counters(summ)

    j, t = _both(gemma, drive)
    assert t == j


def test_deadline_expires_in_queue(gemma):
    def drive(serve, cfg, model, params):
        engine = _engine(serve, model, params, n_slots=1)
        prompts = _prompts(cfg, 3, seed=7)
        head = engine.submit(prompts[0], 6)
        queued = [engine.submit(p, 6, deadline_s=1e-9) for p in prompts[1:]]
        engine.run()
        assert head.finish_reason == "max_new_tokens"
        for s in queued:  # picked by admission after expiry: never held a lane
            assert s.finish_reason == "deadline" and s.out == []
        assert engine.summary()["deadline_expired"] == 2
        return head.out, _counters(engine.summary())

    j, t = _both(gemma, drive)
    assert t == j


def test_retry_budget_exceeded_is_typed(gemma):
    for serve, cfg, model, params in gemma.values():
        engine = _engine(serve, model, params, retry_budget=1)
        s = engine.submit(_prompts(cfg, 1)[0], 4)
        engine.step()  # admit + prefill: the session holds a lane
        assert s in engine.drain()
        engine.requeue(s)  # within budget
        assert s in engine.drain()
        with pytest.raises(serve.RetryBudgetExceeded) as ei:
            engine.requeue(s)
        assert ei.value.session is s and ei.value.budget == 1
        assert s.stats.requeues == 2
        assert engine.summary()["requeues"] == 2


def test_retry_backoff_delays_readmission(gemma):
    def drive(serve, cfg, model, params):
        prompt = _prompts(cfg, 1, seed=10)[0]
        ref = _single_engine_outputs(serve, model, params, [prompt])
        engine = _engine(serve, model, params, retry_backoff=4)
        s = engine.submit(prompt, 8)
        engine.step()  # admit + prefill
        assert s in engine.drain()
        tick0 = engine.tick
        engine.requeue(s)  # 1st requeue: backoff 4 * 2**0
        assert s._backoff_until == tick0 + 4
        engine.run()
        assert s.done and s.out == ref[tuple(prompt)]  # token-exact resume
        assert engine.tick > tick0 + 4  # no re-admission before the backoff horizon
        return s.out, engine.tick, _counters(engine.summary())

    j, t = _both(gemma, drive)
    assert t == j


# ---------------------------------------------------------------------------
# graceful degradation / NaN quarantine / page pressure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["degrades_once", "degrade_disabled_raises",
                                  "oracle_backend_ignores"])
def test_injected_kernel_fault(gemma, case):
    def drive(serve, cfg, model, params):
        prompts = _prompts(cfg, 2, seed=8)
        ref = _single_engine_outputs(serve, model, params, prompts)
        kw = {"degrade_disabled_raises": dict(backend="native", degrade=False),
              "oracle_backend_ignores": dict(backend="oracle")}.get(case, dict(backend="native"))
        engine = _engine(serve, model, params, **kw)
        sessions = [engine.submit(p, 8) for p in prompts]
        inj = serve.FaultInjector(serve.FaultPlan(faults=(
            serve.Fault(tick=2, kind="kernel_fault", duration=3),)), engine)
        if case == "degrade_disabled_raises":
            with pytest.raises(RuntimeError, match="injected"):
                inj.run()
            return engine._degraded, engine.summary()["degradations"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            inj.run()
        degraded = case == "degrades_once"
        assert engine._degraded == degraded
        assert engine._backend() == (ORACLE[serve] if degraded else kw["backend"]
                                     if kw["backend"] not in ("native", "oracle")
                                     else ORACLE[serve])
        assert bool([w for w in caught if "degraded to the" in str(w.message)]) == degraded
        for p, s in zip(prompts, sessions):
            assert s.done and s.out == ref[tuple(p)]
        return [s.out for s in sessions], _counters(engine.summary()), inj.summary()

    j, t = _both(gemma, drive)
    assert t == j


@pytest.mark.parametrize("nan_guard", [True, False])
def test_nan_logits(gemma, nan_guard):
    def drive(serve, cfg, model, params):
        prompts = _prompts(cfg, 2, seed=9)
        ref = _single_engine_outputs(serve, model, params, prompts)
        engine = _engine(serve, model, params, quarantine_ticks=3, nan_guard=nan_guard)
        sessions = [engine.submit(p, 8) for p in prompts]
        inj = serve.FaultInjector(serve.FaultPlan(faults=(
            serve.Fault(tick=2, kind="nan_logits", lanes=(0,)),)), engine)
        inj.run()
        summ = engine.summary()
        if nan_guard:
            assert summ["quarantines"] == 1 and summ["nan_events"] == 1
            assert summ["requeues"] == 1
            for p, s in zip(prompts, sessions):  # poisoned token was never recorded
                assert s.done and s.out == ref[tuple(p)]
        else:
            assert all(s.done for s in sessions) and summ["quarantines"] == 0
        return [s.out for s in sessions], _counters(summ)

    j, t = _both(gemma, drive)
    assert t == j


@pytest.mark.parametrize("page_size", [4, None])
def test_page_pressure(gemma, page_size):
    def drive(serve, cfg, model, params):
        engine = _engine(serve, model, params, page_size=page_size)
        free0 = engine.allocator.free_pages if page_size else None
        s = engine.submit(_prompts(cfg, 1)[0], 6)
        inj = serve.FaultInjector(serve.FaultPlan(faults=(
            serve.Fault(tick=1, kind="page_pressure", pages=3, duration=4),)), engine)
        inj.run()
        assert s.done
        if page_size:
            assert inj.summary()["applied"]["page_pressure"] == 1
            assert engine.allocator.free_pages == free0  # stolen pages came back
        else:  # dense KV: nothing to steal
            assert inj.summary()["skipped"] == 1
        return s.out, inj.summary()

    j, t = _both(gemma, drive)
    assert t == j


def test_run_max_ticks_exhaustion_warns_and_counts(gemma):
    for serve, cfg, model, params in gemma.values():
        engine = _engine(serve, model, params)
        s = engine.submit(_prompts(cfg, 1)[0], 8)
        with pytest.warns(RuntimeWarning, match="work still pending"):
            engine.run(max_ticks=1)
        assert not s.done and engine.summary()["tick_budget_exhausted"] == 1
        engine.run()  # finishes cleanly afterwards
        assert s.done
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=_ecfg(serve, backend="oracle"), n_replicas=2))
        c = cluster.submit(_prompts(cfg, 1)[0], 8)
        with pytest.warns(RuntimeWarning, match="work still"):
            cluster.run(max_ticks=1)
        assert cluster.summary()["tick_budget_exhausted"] == 1
        cluster.run()
        assert c.done


# ---------------------------------------------------------------------------
# serving_chaos's fixed plans through both packages
# ---------------------------------------------------------------------------
CHAOS = dict(n_slots=2, prompt_len=8, out_len=8, requests=6, prefill_chunk=4)


def _chaos_drive(chaos, serve, cfg, model, params, *, backend, page_size, plan=None,
                 guard=None):
    cluster, sessions = chaos._drive_chaos(
        cfg, model, params, backend=backend, page_size=page_size,
        plan=plan() if plan else None, guard=guard, **CHAOS)
    return cluster, sessions


@pytest.mark.parametrize("backend", ["native", "oracle"])
@pytest.mark.parametrize("page_size", [4, None])
def test_serving_chaos_fault_plan_matches_reference(gemma, steady_clock, page_size, backend):
    """``_fault_plan()`` (crash, 4x straggler, kernel fault, NaN lane, page
    pressure) against its clean run: no request lost, tokens exact, and every
    counter equal to the reference's."""
    def drive(serve, cfg, model, params):
        chaos = jchaos if serve is jserve else tchaos
        b = (NATIVE if backend == "native" else ORACLE)[serve]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            clean, cs = _chaos_drive(chaos, serve, cfg, model, params, backend=b,
                                     page_size=page_size)
            faulted, fs = _chaos_drive(chaos, serve, cfg, model, params, backend=b,
                                       page_size=page_size, plan=chaos._fault_plan)
        assert [s.out for s in fs] == [s.out for s in cs]
        summ = faulted.summary()
        assert summ["failovers"] and summ["requeues"] >= 1  # the crash or the straggler
        return ([s.out for s in fs], _counters(clean.summary()), _counters(summ),
                [r.name for r in faulted.to_records("serving_chaos", "f", x="faulted")])

    j, t = _both(gemma, drive)
    assert t == j


def test_serving_chaos_fault_plan_on_real_clocks(gemma):
    """The same plan with wall-clock step times, as the suite runs it: which
    replica the straggler detector flags, and so the tick count, may differ,
    but no request is lost and the tokens equal the clean run's and the
    reference's."""
    def drive(serve, cfg, model, params):
        chaos = jchaos if serve is jserve else tchaos
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            _, clean = _chaos_drive(chaos, serve, cfg, model, params, backend=NATIVE[serve],
                                    page_size=4)
            _, faulted = _chaos_drive(chaos, serve, cfg, model, params, backend=NATIVE[serve],
                                      page_size=4, plan=chaos._fault_plan)
        assert all(s.done for s in faulted)
        return [s.out for s in clean], [s.out for s in faulted]

    j, t = _both(gemma, drive)
    assert t == j
    assert t[0] == t[1]


def test_serving_chaos_guard_fault_plan_matches_reference(gemma, steady_clock):
    """``_guard_fault_plan()`` through the guarded legs (matmul drift, then a
    flash_attention fault): ``_guarded_legs`` raises unless both are detected,
    quarantined op by op and revived by a clean half-open probe, with tokens
    exact against the clean run; its records and their counts must equal the
    reference's."""
    def drive(serve, cfg, model, params):
        chaos = jchaos if serve is jserve else tchaos
        common = dict(backend=NATIVE[serve], page_size=4, seed=0, **CHAOS)
        _, clean = chaos._drive_chaos(cfg, model, params, **common)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            recs = chaos._guarded_legs(cfg, model, params, clean, common)
        guard_rows = {r.name: r.metrics for r in recs if r.name.startswith("serving_chaos_guard_")}
        counts = [(r.name, r.value) for r in recs if r.unit == "count"]
        return [r.name for r in recs], counts, guard_rows, [s.out for s in clean]

    j, t = _both(gemma, drive)
    assert t == j
    degraded = t[2]["serving_chaos_guard_degraded_ops"]
    assert degraded["quarantines"] >= 2 and degraded["revivals"] >= 2


# ---------------------------------------------------------------------------
# the serving suites
# ---------------------------------------------------------------------------
SMOKE = {
    "serving_scaled": {"tps": (1,), "replicas": (1, 2), "requests": 2, "prompt_len": 4,
                       "out_len": 3, "page_sizes": (4,)},
    "serving_chaos": {"requests": 2, "prompt_len": 4, "out_len": 3},
}


@pytest.mark.parametrize("suite,points", [("serving_scaled", 5.0), ("serving_chaos", 2.0)])
def test_serving_suites_match_reference_record_names(suite, points):
    jrunner.load_suites()
    trunner.load_suites()
    over = SMOKE[suite]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = [r.name.replace("[xla]", "[torch]")
                for r in jregistry.get(f"{suite}[xla]").run("quick", overrides=over)]
        recs = tregistry.get(f"{suite}[torch]").run("quick", overrides={**over, "device": "cpu"})
    assert [r.name for r in recs] == want and recs
    assert all(np.isfinite(r.value) for r in recs)
    skipped = tregistry.get(f"{suite}[cuda]").run("quick", overrides={**over, "device": "cpu"})
    assert [(r.name, r.value) for r in skipped] == [(f"{suite}_skipped[cuda]", points)]
    assert sorted(trunner.select([suite])) == [f"{suite}[cuda]", f"{suite}[torch]"]


def test_serving_scaled_skips_points_past_the_visible_devices():
    trunner.load_suites()
    recs = tregistry.get("serving_scaled[torch]").run("quick", overrides={
        **SMOKE["serving_scaled"], "tps": (1, 2), "replicas": (2,), "page_sizes": (),
        "failover": False, "device": "cpu"})
    assert {r.name.split("_")[2] for r in recs} == {"tp1"}  # tp2 needs two devices
    assert {r.x for r in recs} == {1}  # devices used on one device
