"""The port's serving engine against the reference's on the CPU.

The same seeded requests go through ``repro.serve.ServeEngine`` and
``repro_torch.serve.ServeEngine`` over gemma-2b reduced (the reference's
``lm_init`` weights carried across by ``params_from_jax``); every token
stream must be identical, and the engines' counters equal, for the workloads
of ``tests/test_serve.py`` and ``tests/test_guard.py``: prefill chunk sizes,
FCFS and priority admission, user and static schedulers, slot exhaustion,
EOS, max_len, cancel, deadlines, streaming callbacks, NaN-lane quarantine,
whole-engine degradation, a clean guarded run, and injected kernel drift and
faults that are detected, quarantined and healed token-exact.  The CPU has
no hand kernel, so the port's guarded engines run their steps under the
``cuda`` policy (the steps are plain torch ops, which run there) against
``torch`` shadow twins, as the reference runs ``pallas`` against ``xla``.
Also here: ``core.timing.percentile``, the samplers, the metrics records and
the ``serving`` suite's record names.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.bench import runner as jrunner
from repro.core import registry as jregistry
from repro.core.timing import percentile as jpercentile
from repro.kernels import guard as jguard
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.bench import runner as trunner
from repro_torch.core import registry as tregistry
from repro_torch.core.timing import percentile as tpercentile
from repro_torch.kernels import api as tapi
from repro_torch.kernels import guard as tguard
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax


@pytest.fixture(scope="module")
def gemma():
    """Both packages' gemma-2b reduced models over the reference's init."""
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return (jcfg, jmodel, jparams), (tcfg, tbuild(tcfg, device="cpu"), tparams)


@pytest.fixture(autouse=True)
def _fresh_guards():
    with jguard.isolated(), tguard.isolated():
        yield


def _prompts(cfg, n, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, lens[i % len(lens)])]
            for i in range(n)]


def _both(gemma, config: dict, drive, *, jsched=None, tsched=None, port_config=None):
    """Build the reference's engine and the port's from the same config
    (``port_config`` adds port-only fields), run ``drive(engine, serve)`` on
    each, and return both results."""
    (_, jmodel, jparams), (_, tmodel, tparams) = gemma
    je = jserve.ServeEngine(jmodel, jparams, jserve.EngineConfig(**config),
                            scheduler=jsched() if jsched else None)
    te = tserve.ServeEngine(tmodel, tparams,
                            tserve.EngineConfig(**config, **(port_config or {})),
                            scheduler=tsched() if tsched else None)
    return drive(je, jserve), drive(te, tserve)


COUNTERS = ("requests", "cancelled", "generated_tokens", "prefill_tokens", "ticks",
            "deadline_expired", "requeues", "quarantines", "nan_events", "degradations",
            "guard_checks", "drift_events", "op_degradations", "op_revivals", "preemptions")


def _counters(engine) -> dict:
    s = engine.summary()
    return {k: s[k] for k in COUNTERS}


# ---------------------------------------------------------------------------
# timing helper, samplers, metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q", [0, 25, 50, 95, 99, 100])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 64])
def test_percentile_matches_reference(n, q):
    samples = list(np.random.default_rng(n).exponential(size=n))
    want, got = jpercentile(samples, q), tpercentile(samples, q)
    assert (np.isnan(got) and np.isnan(want)) if n == 0 else got == want


def test_samplers():
    logits = np.random.default_rng(0).standard_normal((4, 50)).astype(np.float32)
    t = torch.from_numpy(logits)
    assert np.array_equal(tserve.greedy(t).numpy(), np.asarray(jserve.greedy(logits)))
    assert tserve.greedy(t).dtype == torch.int32
    draws = [tserve.temperature_sample(t, torch.Generator().manual_seed(3), 0.7)
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (4,)
    assert draws[0].dtype == torch.int32 and int(draws[0].max()) < 50
    top = tserve.top_k_sample(t, torch.Generator().manual_seed(5), k=3)
    top3 = torch.topk(t, 3, dim=-1).indices
    assert top.shape == (4,) and all(int(top[i]) in top3[i].tolist() for i in range(4))
    cold = tserve.temperature_sample(t, torch.Generator().manual_seed(1), 1e-6)
    assert torch.equal(cold, tserve.greedy(t))  # near-zero temperature is greedy


def _fake_sessions(serve):
    out = []
    for i, (reason, n) in enumerate((("max_new_tokens", 4), ("eos", 2), ("deadline", 3),
                                     ("cancelled", 1))):
        s = serve.Session(i, [1, 2], 8)
        s.stats.submitted_at = 1.0
        s.stats.first_token_at = 1.0 + 0.01 * (i + 1)
        s.stats.token_times = [1.0 + 0.01 * (i + 1) + 0.002 * j * (i + 1) for j in range(n)]
        s.out = list(range(n))
        s.finish_reason = reason
        out.append(s)
    return out


@pytest.mark.parametrize("n_pages", [0, 24])
def test_engine_and_cluster_metrics_match_reference(n_pages):
    ms = []
    for serve in (jserve, tserve):
        m = serve.EngineMetrics(3, n_pages=n_pages)
        for s in _fake_sessions(serve):
            m.record_finished(s)
        for i in range(5):
            m.record_tick(0.01 * (i + 1), 0.008 * (i + 1), 1 + i % 3)
            m.record_pages(4 + i)
        m.record_prefill(0.02, 17, 2)
        m.record_prefix_hit(6)
        m.record_preemption()
        m.record_guard_check()
        m.record_drift_event()
        m.record_op_degradation(2)
        ms.append(m)
    rec = [[(r.name, r.value, r.unit, r.better, r.metrics, r.x, r.info)
            for r in m.to_records("serving", "serving_x", x="s3")] for m in ms]
    assert rec[1] == rec[0]
    assert ms[1].summary() == ms[0].summary()
    cj, ct = jserve.ClusterMetrics(), tserve.ClusterMetrics()
    for c, serve in ((cj, jserve), (ct, tserve)):
        c.record_route()
        c.record_failure(_fake_sessions(serve)[:2], reason="heartbeat")
        c.record_liveness(1, 2)
    assert ct.summary([ms[1], ms[1]]) == cj.summary([ms[0], ms[0]])
    crec = [[(r.name, r.value, r.metrics) for r in c.to_records(m, "serving_scaled", "c")]
            for c, m in ((cj, [ms[0]]), (ct, [ms[1]]))]
    assert crec[1] == crec[0]


# ---------------------------------------------------------------------------
# engine token streams against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_prefill_chunk_size_streams_match_reference(gemma, chunk):
    (jcfg, _, _), _ = gemma
    prompts = _prompts(jcfg, 3, [6, 11], seed=1)

    def drive(eng, serve):
        ss = [eng.submit(p, 5) for p in prompts]
        eng.run(300)
        return [s.out for s in ss], _counters(eng)

    j, t = _both(gemma, dict(n_slots=2, max_len=48, prefill_chunk=chunk), drive)
    assert t == j


def test_fcfs_and_priority_streams_and_order_match_reference(gemma):
    (jcfg, _, _), _ = gemma
    prompts = _prompts(jcfg, 6, [4, 6, 5], seed=2)

    def drive_with(priorities):
        def drive(eng, serve):
            ss = [eng.submit(p, 4, priority=pr) for p, pr in zip(prompts, priorities)]
            fin = eng.run(500)
            return {s.rid: s.out for s in ss}, [s.rid for s in fin]
        return drive

    fj, ft = _both(gemma, dict(n_slots=2, max_len=48), drive_with([0] * 6),
                   jsched=jserve.FCFSScheduler, tsched=tserve.FCFSScheduler)
    pj, pt = _both(gemma, dict(n_slots=2, max_len=48), drive_with(list(range(6))),
                   jsched=jserve.PriorityScheduler, tsched=tserve.PriorityScheduler)
    assert (ft, pt) == (fj, pj)
    assert ft[0] == pt[0] and ft[1] != pt[1]  # same tokens, other admission order


def test_user_and_static_schedulers_match_reference(gemma):
    def lifo(serve):
        class LIFOScheduler:
            def __init__(self):
                self.stack = []

            def submit(self, session):
                self.stack.append(session)

            def select(self, n_free, n_slots):
                out = []
                while self.stack and len(out) < n_free:
                    s = self.stack.pop()
                    if not s.done:
                        out.append(s)
                return out

            def pending(self):
                return sum(1 for s in self.stack if not s.done)

        return LIFOScheduler

    def drive(eng, serve):
        a, b = eng.submit([3, 4], 2), eng.submit([5, 6], 2)
        return [s.rid for s in eng.run(100)], a.out, b.out

    j, t = _both(gemma, dict(n_slots=1, max_len=32), drive, jsched=lifo(jserve),
                 tsched=lifo(tserve))
    assert t == j and t[0] == [1, 0]

    def drive_static(eng, serve):
        ss = [eng.submit([2 + i, 7], 3) for i in range(3)]
        eng.step()
        statuses = [[s.status for s in ss]]
        while ss[2].status == "queued" and eng.has_work():
            eng.step()
        done_first = (ss[0].done, ss[1].done)
        fin = eng.run(200)
        return statuses, done_first, [s.rid for s in fin], [s.out for s in ss]

    j, t = _both(gemma, dict(n_slots=2, max_len=32), drive_static,
                 jsched=jserve.StaticBatchScheduler, tsched=tserve.StaticBatchScheduler)
    assert t == j and t[1] == (True, True) and t[0][0][2] == "queued"


def test_slot_exhaustion_eos_and_max_len_match_reference(gemma):
    (jcfg, _, _), _ = gemma
    prompts = _prompts(jcfg, 7, [4], seed=4)

    def drive(eng, serve):
        ss = [eng.submit(p, 3) for p in prompts]
        active = []
        while eng.has_work():
            eng.step()
            active.append(sum(s is not None for s in eng.slots))
        return [s.out for s in ss], active, _counters(eng)

    j, t = _both(gemma, dict(n_slots=2, max_len=48), drive)
    assert t == j and max(t[1]) == 2

    def probe(eng, serve):
        s = eng.submit([5, 6, 7], 8)
        eng.run(100)
        return s.out

    j, t = _both(gemma, dict(n_slots=1, max_len=48), probe)
    assert t == j and len(t) == 8
    eos = t[2]

    def drive_eos(eng, serve):
        s = eng.submit([5, 6, 7], 8)
        eng.run(100)
        return s.finish_reason, s.out, eng.slots[0]

    j, t = _both(gemma, dict(n_slots=1, max_len=48, eos_id=eos), drive_eos)
    assert t == j and t[0] == "eos" and len(t[1]) == 3

    def drive_max_len(eng, serve):
        s = eng.submit([1, 2, 3, 4, 5], max_new_tokens=50)
        eng.run(100)
        return s.finish_reason, s.out

    j, t = _both(gemma, dict(n_slots=1, max_len=8), drive_max_len)
    assert t == j and t[0] == "max_len" and len(t[1]) == 8 - 5 + 1


def test_cancellation_and_deadlines_match_reference(gemma):
    def drive_cancel(eng, serve):
        running = eng.submit([3, 4, 5], 50)
        queued = eng.submit([6, 7], 4)
        eng.step()
        seen = [running.status, queued.status]
        queued.cancel()
        seen.append(queued.status)
        eng.step()
        n_before = len(running.out)
        running.cancel()
        fin = eng.run(100)
        return (seen, running.finish_reason, running.out, n_before,
                [s.rid for s in fin], eng.has_work(), _counters(eng))

    j, t = _both(gemma, dict(n_slots=1, max_len=32), drive_cancel)
    assert t == j and t[0] == ["active", "queued", "cancelled"] and len(t[2]) == t[3]

    def drive_deadline(eng, serve):
        late = eng.submit([3, 4, 5], 6, deadline_s=1e-9)  # expires before admission
        live = eng.submit([6, 7, 8], 20)
        eng.step()
        eng.step()
        live.deadline_s = 1e-9  # expires mid-generation, partial output kept
        eng.run(100)
        return (late.finish_reason, late.out, live.finish_reason, live.out, _counters(eng))

    j, t = _both(gemma, dict(n_slots=1, max_len=32), drive_deadline)
    assert t == j and t[0] == t[2] == "deadline" and t[1] == [] and len(t[3]) == 2


def test_streaming_callback_order_and_stats(gemma):
    _, (_, tmodel, tparams) = gemma
    eng = tserve.ServeEngine(tmodel, tparams, tserve.EngineConfig(n_slots=2, max_len=32))
    got = []
    s = eng.submit([4, 5, 6], 5, on_token=lambda sess, tok: got.append(tok))
    eng.run(100)
    assert got == s.out and len(got) == 5
    st = s.stats
    assert st.finished_at >= st.first_token_at >= st.admitted_at >= st.submitted_at
    assert len(st.token_times) == 5 and len(st.token_latencies_s) == 4
    summ = eng.summary()
    assert summ["requests"] == 1 and summ["generated_tokens"] == 5 and summ["ttft_ms_p50"] > 0


def test_nan_lane_quarantine_retries_token_exact_as_the_reference(gemma):
    (jcfg, _, _), _ = gemma
    prompts = _prompts(jcfg, 3, [5, 3], seed=6)

    def drive(eng, serve):
        ss = [eng.submit(p, 6) for p in prompts]
        for tick in range(200):
            eng._inject_nan_lanes = {0} if tick == 2 else set()
            if not eng.has_work():
                break
            eng.step()
        return [s.out for s in ss], _counters(eng)

    j, t = _both(gemma, dict(n_slots=2, max_len=32, prefill_chunk=4), drive)
    assert t == j and t[1]["nan_events"] == 1 and t[1]["quarantines"] == 1


@pytest.mark.parametrize("degrade", [True, False])
def test_step_failure_degrades_once_as_the_reference(gemma, degrade):
    """An injected step error with the guard off: with ``degrade`` the engine
    re-binds its steps to the oracle backend once and finishes token-exact;
    without it the error propagates."""
    (jcfg, _, _), _ = gemma
    prompts = _prompts(jcfg, 2, [5, 4], seed=7)

    def drive(eng, serve):
        ss = [eng.submit(p, 5) for p in prompts]
        eng.step()
        eng._inject_step_error = RuntimeError("injected step failure")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                eng.run(100)
        except RuntimeError as err:
            return "raised", str(err)
        return [s.out for s in ss], eng._degraded, _counters(eng)

    j, t = _both(gemma, dict(n_slots=2, max_len=32, degrade=degrade), drive,
                 port_config={"backend": "cuda"})
    assert t == j
    assert t[0] == ("raised" if not degrade else t[0]) and (not degrade or t[1])


def test_drain_returns_every_session_as_the_reference(gemma):
    (jcfg, _, _), _ = gemma
    prompts = _prompts(jcfg, 4, [5, 4], seed=8)

    def drive(eng, serve):
        ss = [eng.submit(p, 6) for p in prompts]
        eng.step()
        eng.step()
        drained = eng.drain()
        return ([(s.rid, s.status, s.stats.preemptions, list(s.out)) for s in drained],
                eng.has_work(), [s.rid for s in ss])

    j, t = _both(gemma, dict(n_slots=2, max_len=32), drive)
    assert t == j and not t[1] and len(t[0]) == 4


def test_requeue_budget_and_engine_refusals(gemma):
    _, (tcfg, tmodel, tparams) = gemma
    eng = tserve.ServeEngine(tmodel, tparams,
                             tserve.EngineConfig(n_slots=1, max_len=16, retry_budget=1))
    s = eng.submit([1, 2], 2)
    eng.requeue(s)
    with pytest.raises(tserve.RetryBudgetExceeded, match="retry_budget=1"):
        eng.requeue(s)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([], 4)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(1, 17)), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1, 2], 0)
    with pytest.raises(TypeError, match="Scheduler protocol"):
        tserve.ServeEngine(tmodel, tparams, tserve.EngineConfig(n_slots=1, max_len=16),
                           scheduler=object())
    with pytest.raises(NotImplementedError, match="item 11"):
        tserve.ServeEngine(tmodel, tparams,
                           tserve.EngineConfig(n_slots=1, max_len=16, mesh=object()))
    zcfg = tconfigs.get_config("zamba2-7b").reduced()
    with pytest.raises(tserve.UnsupportedFamilyError, match="decode_chunk") as ei:
        tserve.ServeEngine(tbuild(zcfg, device="cpu"), None,
                           tserve.EngineConfig(n_slots=2, max_len=16))
    assert ei.value.family == "hybrid" and isinstance(ei.value, NotImplementedError)


def test_engine_backend_policy_scoped_per_engine(gemma):
    """Each engine's steps run under its own kernel policy, entered on every
    call: two engines over the same model see their own backends."""
    _, (tcfg, tmodel, tparams) = gemma
    seen = []
    orig = tmodel.decode_step

    def spy(p, cache, toks, pos):
        seen.append(tapi.current_policy().backend)
        return orig(p, cache, toks, pos)

    spy_model = dataclasses.replace(tmodel, decode_step=spy)
    for backend in ("torch", "cuda"):
        eng = tserve.ServeEngine(spy_model, tparams,
                                 tserve.EngineConfig(n_slots=1, max_len=16, backend=backend))
        eng.submit([3, 4], 3)
        eng.run(50)
    assert seen == ["torch", "torch", "cuda", "cuda"]
    assert tapi.current_policy().backend is None


# ---------------------------------------------------------------------------
# the numerics guard in the engine
# ---------------------------------------------------------------------------
GUARD_ENGINE = dict(n_slots=2, max_len=32, prefill_chunk=4)


def _guard_prompts(gemma):
    (jcfg, _, _), _ = gemma
    return _prompts(jcfg, 2, [5], seed=5)


def test_guarded_engine_clean_run_is_exact_with_zero_drift(gemma):
    prompts = _guard_prompts(gemma)

    def drive(eng, serve):
        ss = [eng.submit(p, 8) for p in prompts]
        eng.run()
        return [s.out for s in ss], _counters(eng)

    (jplain, _), (tplain, _) = _both(gemma, GUARD_ENGINE, drive)
    j, t = _both(gemma, dict(GUARD_ENGINE, guard="shadow"), drive,
                 port_config={"backend": "cuda"})
    assert tplain == jplain == t[0] == j[0]
    assert t[1] == j[1] and t[1]["guard_checks"] > 0
    assert t[1]["drift_events"] == t[1]["op_degradations"] == 0

    def drive_sample(eng, serve):
        ss = [eng.submit(p, 8) for p in prompts]
        eng.run()
        return [s.out for s in ss], _counters(eng)

    j, t = _both(gemma, dict(GUARD_ENGINE, guard="sample", guard_sample=3), drive_sample,
                 port_config={"backend": "cuda"})
    assert t == j and 0 < t[1]["guard_checks"] < t[1]["ticks"]


def _port_fault_replay(eng, plan):
    """The reference's ``FaultInjector`` for kernel_drift / kernel_fault
    faults, tick for tick, against the port's engine and guard (the port's
    fault layer waits for the serving cluster)."""
    active, tick, rngs = [], 0, {}
    drift_ops, fault_ops = set(), set()

    def sync():
        nonlocal drift_ops, fault_ops
        errs = [f for f in active if f.kind == "kernel_fault"]
        err = RuntimeError(errs[-1].message) if errs else None
        if err is not None and errs[-1].op is not None:
            err.op = errs[-1].op
        eng._inject_step_error = err
        drifts = [f for f in active if f.kind == "kernel_drift"]
        eng._inject_drift = ({"op": drifts[-1].op, "scale": drifts[-1].drift_scale,
                              "rng": rngs[id(drifts[-1])]} if drifts else None)
        now_drift = {f.op for f in drifts}
        now_fault = {f.op for f in errs if f.op is not None}
        for op in now_drift - drift_ops:
            f = next(f for f in drifts if f.op == op)
            tguard.inject_drift(op, scale=f.drift_scale, seed=(plan.seed or 0) * 7919 + f.tick)
        for op in drift_ops - now_drift:
            tguard.clear_drift(op)
        for op in now_fault - fault_ops:
            f = next(f for f in errs if f.op == op)
            tguard.inject_fault(op, f.message)
        for op in fault_ops - now_fault:
            tguard.clear_fault(op)
        drift_ops, fault_ops = now_drift, now_fault

    ends = {}  # id(fault) -> first tick it is no longer active
    while eng.has_work() or active or tick < plan.horizon:
        due = [f for f in active if ends[id(f)] <= tick]
        if due:
            active = [f for f in active if ends[id(f)] > tick]
            for f in due:
                rngs.pop(id(f), None)
            sync()
        for f in plan.at(tick):
            if f.kind == "kernel_drift":
                rngs[id(f)] = np.random.default_rng((plan.seed or 0) * 7919 + f.tick)
            ends[id(f)] = tick + f.duration
            active.append(f)
            sync()
        eng.step()
        tick += 1
    active = []
    sync()


def _guard_plan():
    return jserve.FaultPlan(seed=42, faults=(
        jserve.Fault(tick=2, kind="kernel_drift", replica=0, duration=2, op="matmul",
                     drift_scale=0.25),
        jserve.Fault(tick=6, kind="kernel_fault", replica=0, op="flash_attention"),
    ))


def test_guarded_engine_detects_quarantines_heals_token_exact_as_the_reference(gemma):
    """Injected drift in the step's logits and an injected step fault, each
    named after a kernel op: every perturbed step is caught by the shadow
    twin, exactly the named ops are quarantined (never the whole engine), the
    token streams stay exact, and both ops heal — event for event as the
    reference's engine under its FaultInjector."""
    prompts = _guard_prompts(gemma)

    def drive(eng, serve):
        ss = [eng.submit(p, 8) for p in prompts]
        with pytest.warns(RuntimeWarning, match="quarantined kernel op"):
            if serve is jserve:
                jserve.FaultInjector(_guard_plan(), eng).run()
            else:
                _port_fault_replay(eng, _guard_plan())
        guard = jguard if serve is jserve else tguard
        mid = (_counters(eng), eng._injected_drift_calls, sorted(guard.metrics().quarantined_ops),
               eng._degraded)
        heal = eng.submit(prompts[0], 4)
        eng.run()
        return ([s.out for s in ss], heal.out, mid, _counters(eng), dict(eng._op_quarantine),
                guard.quarantined_ops())

    j, t = _both(gemma, dict(GUARD_ENGINE, guard="shadow", guard_cooldown=2), drive,
                 port_config={"backend": "cuda"})

    def plain(eng, serve):
        ss = [eng.submit(p, 8) for p in prompts]
        eng.run()
        return [s.out for s in ss]

    jplain, tplain = _both(gemma, GUARD_ENGINE, plain)
    assert t == j
    outs, _, mid, final, op_q, quarantined = t
    assert outs == tplain == jplain
    counters, drift_calls, ever, degraded = mid
    assert drift_calls >= 1 and counters["drift_events"] == drift_calls
    assert ever == ["flash_attention", "matmul"] and not degraded
    assert counters["op_degradations"] == 2 and counters["degradations"] == 0
    assert final["op_revivals"] == 2 and not op_q and not quarantined


# ---------------------------------------------------------------------------
# the serving suite
# ---------------------------------------------------------------------------
def test_serving_suite_record_names_match_reference():
    jrunner.load_suites()
    trunner.load_suites()
    over = {"requests": 2, "out_lens": (3,), "prompt_lens": (4,)}
    want = [r.name.replace("[xla]", "[torch]")
            for r in jregistry.get("serving[xla]").run("quick", overrides=over)]
    recs = tregistry.get("serving[torch]").run("quick", overrides={**over, "device": "cpu"})
    assert [r.name for r in recs] == want
    assert {"ms", "tok/s"} <= {r.unit for r in recs}
    eqmem = {r.name: r.value for r in recs if "concurrency" in r.name and "eqmem" in r.name}
    dense = next(v for k, v in eqmem.items() if "dense" in k)
    assert next(v for k, v in eqmem.items() if "paged" in k) > dense
    skipped = tregistry.get("serving[cuda]").run("quick", overrides={**over, "device": "cpu"})
    assert [(r.name, r.value) for r in skipped] == [("serving_skipped[cuda]", 5.0)]
    assert sorted(n for n in trunner.select(["serving"])) == ["serving[cuda]", "serving[torch]"]
