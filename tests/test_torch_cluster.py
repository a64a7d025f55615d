"""The port's serving cluster against the reference's on the CPU.

The single-device cases of ``tests/test_cluster.py``, each run through
``repro.serve`` and ``repro_torch.serve`` on gemma-2b reduced (the
reference's ``lm_init`` weights carried across by ``params_from_jax``) with
the same numpy-seeded prompts: router policies on stub replicas, the cluster
equal to one engine under every built-in router (dense and paged), the
requests per replica, the ``summary()`` counters and the ``to_records``
names, prefix affinity, failover drain/requeue, the engine's drain, custom
routers, and the configuration checks.  Port-only: ``replica_meshes`` over
``torch.device`` pools (one device shares the params, several wrap around,
``tp > 1`` raises) and the typed family refusal at ``submit()``, shown with
zamba2 reduced (the port builds the hybrid family, which the engine refuses).
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.core.timing import NoCudaDeviceError
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_jax


@pytest.fixture(scope="module")
def gemma():
    """Both packages' gemma-2b reduced models over the reference's init:
    ``{"jax": (serve, cfg, model, params), "torch": (...)}``."""
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return {"jax": (jserve, jcfg, jmodel, jparams),
            "torch": (tserve, tcfg, tbuild(tcfg, device="cpu"), tparams)}


def _both(gemma, drive):
    """``drive(serve, cfg, model, params)`` in each package -> (reference, port)."""
    return drive(*gemma["jax"]), drive(*gemma["torch"])


def _prompts(cfg, n, lens=(3, 5, 4), seed=0):
    rng = np.random.default_rng(seed)
    return [
        [int(t) for t in rng.integers(1, cfg.vocab_size, lens[i % len(lens)])]
        for i in range(n)
    ]


def _single_engine_outputs(serve, model, params, prompts, max_new=8, **cfg_kw):
    engine = serve.ServeEngine(
        model, params, serve.EngineConfig(n_slots=2, max_len=32, prefill_chunk=4, **cfg_kw)
    )
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


# ---------------------------------------------------------------------------
# routing policies (unit, no engines)
# ---------------------------------------------------------------------------
class _StubReplica:
    def __init__(self, index, load, alive=True):
        self.index, self._load, self.alive = index, load, alive

    def load(self):
        return self._load


def _policy_trace(serve, name):
    if name == "round_robin":
        policy = serve.RoundRobinPolicy()
        replicas = [_StubReplica(0, 0), _StubReplica(1, 0, alive=False), _StubReplica(2, 0)]
        return [policy.place([1], 0, replicas) for _ in range(4)]
    if name == "least_loaded":
        policy = serve.LeastLoadedPolicy()
        replicas = [_StubReplica(0, 5), _StubReplica(1, 2), _StubReplica(2, 2)]
        first = policy.place([1], 0, replicas)
        replicas[1].alive = False
        return [first, policy.place([1], 0, replicas)]
    policy = serve.PrefixAffinityPolicy()
    replicas = [_StubReplica(0, 9), _StubReplica(1, 0), _StubReplica(2, 3)]
    policy.note_prefix([1, 2], 0)
    policy.note_prefix([1, 2, 3], 2)
    picks = [policy.place(p, 0, replicas) for p in ([1, 2, 3, 4], [1, 2, 9], [7, 8, 9])]
    policy.forget_replica(2)
    return picks + [policy.place([1, 2, 3, 4], 0, replicas)]


@pytest.mark.parametrize("name,want", [
    ("round_robin", [0, 2, 0, 2]),  # cycles, skipping the dead replica
    ("least_loaded", [1, 2]),  # min load, lowest index; then the next live one
    ("prefix_affinity", [2, 0, 1, 0]),  # longest prefix, shorter, none, survivor's
])
def test_router_policies_match_reference(name, want):
    assert _policy_trace(tserve, name) == _policy_trace(jserve, name) == want


def test_make_router_unknown_name():
    for serve in (tserve, jserve):
        with pytest.raises(ValueError, match="unknown router") as ei:
            serve.make_router("nope")
        assert "least_loaded" in str(ei.value)
    assert sorted(tserve.ROUTERS) == sorted(jserve.ROUTERS)
    for name in tserve.ROUTERS:
        assert type(tserve.make_router(name)).__name__ == type(jserve.make_router(name)).__name__


# ---------------------------------------------------------------------------
# device topology
# ---------------------------------------------------------------------------
def test_replica_meshes_single_device_and_errors():
    cpu = torch.device("cpu")
    assert tserve.replica_meshes(3, tp=1, devices=[cpu]) == [None, None, None]
    assert jserve.replica_meshes(3, tp=1, devices=jax.devices()[:1]) == [None, None, None]
    for serve, devs in ((tserve, [cpu]), (jserve, jax.devices()[:1])):
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            serve.replica_meshes(1, tp=2, devices=devs)
        with pytest.raises(ValueError, match="n_replicas must be >= 1"):
            serve.replica_meshes(0, devices=devs)
        with pytest.raises(ValueError, match="tp must be >= 1"):
            serve.replica_meshes(1, tp=0, devices=devs)


def test_replica_meshes_several_devices_and_tensor_parallel(monkeypatch):
    pool = [torch.device("cpu"), torch.device("meta")]
    assert tserve.replica_meshes(3, devices=pool) == [pool[0], pool[1], pool[0]]  # wraps
    # tp ranks a replica, wrapping around the pool as the reference's meshes do
    assert tserve.replica_meshes(2, tp=2, devices=pool) == [tuple(pool), tuple(pool)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):  # the default pool is the visible cards
        tserve.replica_meshes(2)


def test_replicas_on_one_device_share_the_params(gemma):
    serve, cfg, model, params = gemma["torch"]
    for devices in (None, (torch.device("cpu"), torch.device("cpu"))):
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=serve.EngineConfig(n_slots=2, max_len=32, prefill_chunk=4),
            n_replicas=2, devices=devices))
        s = cluster.submit(_prompts(cfg, 1)[0], 3)
        cluster.run()
        assert s.done
        engines = [r.engine for r in cluster.replicas]
        assert engines[0].params is engines[1].params is params  # nothing copied
        assert engines[0].cache is not engines[1].cache  # each keeps its own KV
        assert all(r.engine.model is model for r in cluster.replicas)


def test_max_useful_tp(gemma):
    for serve, cfg, _, _ in gemma.values():  # reduced gemma: n_heads=4, n_kv_heads=1
        assert cfg.max_useful_tp() == 1
        assert cfg.replace(n_kv_heads=2).max_useful_tp() == 2
        assert cfg.replace(n_kv_heads=4).max_useful_tp() == 4
        assert cfg.replace(n_kv_heads=4).max_useful_tp(limit=2) == 2


# ---------------------------------------------------------------------------
# typed family refusal
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def zamba():
    cfg = tconfigs.get_config("zamba2-7b").reduced()
    model = tbuild(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def test_engine_raises_typed_family_error(zamba):
    cfg, model, params = zamba
    with pytest.raises(tserve.UnsupportedFamilyError) as exc:
        tserve.ServeEngine(model, params, tserve.EngineConfig(n_slots=2, max_len=16))
    assert exc.value.family == cfg.family == "hybrid"
    assert exc.value.missing == "decode_chunk"
    assert "dense" in str(exc.value)  # names the fallback families
    assert isinstance(exc.value, NotImplementedError)
    want = jserve.UnsupportedFamilyError("hybrid")
    assert str(exc.value) == str(want)


def test_cluster_surfaces_family_error_at_submit(zamba):
    _, model, params = zamba
    cluster = tserve.ClusterRouter(model, params, tserve.ClusterConfig(
        engine=tserve.EngineConfig(n_slots=2, max_len=16), n_replicas=2))
    assert cluster.replicas == []  # construction is lazy: no error until the first submit
    with pytest.raises(tserve.UnsupportedFamilyError, match="decode_chunk"):
        cluster.submit([1, 2, 3], 4)


# ---------------------------------------------------------------------------
# cluster == single engine (token streams)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page_size", [None, 4])
@pytest.mark.parametrize("router", ["round_robin", "least_loaded", "prefix_affinity"])
def test_cluster_matches_single_engine_and_reference(gemma, router, page_size):
    def drive(serve, cfg, model, params):
        prompts = _prompts(cfg, 6)
        ref = _single_engine_outputs(serve, model, params, prompts, page_size=page_size)
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=serve.EngineConfig(n_slots=2, max_len=32, prefill_chunk=4,
                                      page_size=page_size),
            n_replicas=2, router=router))
        sessions = [cluster.submit(p, 8) for p in prompts]
        cluster.run()
        assert [s.out for s in sessions] == [ref[tuple(p)] for p in prompts], router
        rids = [s.rid for s in sessions]
        assert len(set(rids)) == len(rids)  # cluster-unique (per-replica stride)
        return ([s.out for s in sessions], rids, [cluster._placement[r] for r in rids],
                _counters(cluster.summary()))

    j, t = _both(gemma, drive)
    assert t == j
    assert sorted(set(t[2])) == [0, 1]  # both replicas served


def test_cluster_metrics_aggregate(gemma):
    def drive(serve, cfg, model, params):
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=serve.EngineConfig(n_slots=2, max_len=32, prefill_chunk=4),
            n_replicas=2))
        for p in _prompts(cfg, 6, seed=1):
            cluster.submit(p, 6)
        cluster.run()
        summ = cluster.summary()
        per = summ["per_replica"]
        assert summ["replicas"] == 2 and len(per) == 2
        assert summ["requests"] == 6 == sum(r["requests"] for r in per)
        assert summ["generated_tokens"] == sum(r["generated_tokens"] for r in per)
        assert summ["routed"] == 6 and summ["failures"] == 0
        assert 0 < summ["occupancy"] <= 1 and summ["throughput_tok_s"] > 0
        recs = cluster.to_records("serving_scaled", "cluster", x=2)
        assert all(r.metrics["replicas"] == 2 for r in recs)
        return (_counters(summ), [r["requests"] for r in per],
                [(r.name, r.unit, r.better, r.x) for r in recs])

    j, t = _both(gemma, drive)
    assert t == j
    assert {n for n, *_ in t[2]} == {
        "cluster_ttft", "cluster_tok_latency_p95", "cluster_throughput", "cluster_occupancy",
        "cluster_goodput", "cluster_availability", "cluster_faults",
    }


def test_prefix_affinity_routes_to_prefix_owner(gemma):
    def drive(serve, cfg, model, params):
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=serve.EngineConfig(n_slots=2, max_len=32, prefill_chunk=4, page_size=4),
            n_replicas=2, router="prefix_affinity"))
        prefix = [1, 2, 3, 4]
        cluster.register_prefix(prefix, replica=1)
        s = cluster.submit(prefix + [5, 6], 4)
        assert cluster._placement[s.rid] == 1
        cluster.run()
        assert s.done
        # the fork actually reused shared pages on the owning replica
        assert cluster.replicas[1].engine.metrics.prefix_hits == 1
        return s.out, _counters(cluster.summary())

    j, t = _both(gemma, drive)
    assert t == j


# ---------------------------------------------------------------------------
# failure drain / requeue
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page_size", [None, 4])
def test_failover_resumes_token_exact(gemma, page_size):
    def drive(serve, cfg, model, params):
        prompts = _prompts(cfg, 6, seed=2)
        ref = _single_engine_outputs(serve, model, params, prompts)
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=serve.EngineConfig(n_slots=2, max_len=32, prefill_chunk=4,
                                      page_size=page_size),
            n_replicas=2, router="round_robin"))
        sessions = [cluster.submit(p, 8) for p in prompts]
        for _ in range(3):  # some sessions mid-decode, some still queued
            cluster.step()
        drained = cluster.fail_replica(0)
        assert drained and any(s.out for s in drained)  # in-flight output kept
        cluster.run()
        for p, s in zip(prompts, sessions):
            assert s.done and s.out == ref[tuple(p)], ("failover", p)
        summ = cluster.summary()
        assert summ["failures"] == 1 and summ["requeued_sessions"] == len(drained)
        assert summ["failovers"] == {"manual": 1}
        assert not cluster.replicas[0].alive
        with pytest.raises(ValueError, match="already failed"):
            cluster.fail_replica(0)
        return ([s.out for s in sessions], [s.rid for s in drained],
                [s.stats.requeues for s in sessions], _counters(summ))

    j, t = _both(gemma, drive)
    assert t == j


def test_failover_last_replica_raises(gemma):
    for serve, cfg, model, params in gemma.values():
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=serve.EngineConfig(n_slots=2, max_len=32, prefill_chunk=4),
            n_replicas=1))
        cluster.submit(_prompts(cfg, 1)[0], 4)
        with pytest.raises(RuntimeError, match="no live replicas"):
            cluster.fail_replica(0)


class _NoDrainFCFS:
    """Scheduler without the optional drain() — exercises the select-loop
    fallback in ServeEngine.drain."""

    def __init__(self):
        self._q = []

    def submit(self, s):
        self._q.append(s)

    def select(self, n_free, n_slots):
        out, self._q = self._q[:n_free], self._q[n_free:]
        return [s for s in out if not s.done]

    def pending(self):
        return sum(1 for s in self._q if not s.done)


class _WithholdingScheduler(_NoDrainFCFS):
    """Claims pending work but never releases it — drain() must terminate
    (and strand the queue) instead of spinning on select()."""

    def select(self, n_free, n_slots):
        return []


@pytest.mark.parametrize("case", ["running_and_queued", "no_scheduler_drain",
                                  "preemptions_for_slot_drained_only", "withholding"])
def test_engine_drain(gemma, case):
    def drive(serve, cfg, model, params):
        sched = {"no_scheduler_drain": _NoDrainFCFS,
                 "withholding": _WithholdingScheduler}.get(case)
        engine = serve.ServeEngine(
            model, params, serve.EngineConfig(n_slots=2, max_len=32, prefill_chunk=4),
            scheduler=sched() if sched else None)
        seed = {"running_and_queued": 3, "no_scheduler_drain": 4,
                "preemptions_for_slot_drained_only": 5, "withholding": 6}[case]
        n = 4 if case == "no_scheduler_drain" else 3 if case == "withholding" else 5
        sessions = [engine.submit(p, 8) for p in _prompts(cfg, n, seed=seed)]
        if case in ("running_and_queued", "preemptions_for_slot_drained_only"):
            engine.step()  # two running, three queued
        running = {s.rid for s in sessions if s.status != "queued"}
        drained = engine.drain()
        if case == "withholding":  # would loop forever without the empty-batch stop
            assert drained == [] and engine.scheduler.pending() == 3
        else:
            assert len(drained) == n and engine.scheduler.pending() == 0
            assert all(s.status == "queued" for s in drained) and not engine.has_work()
            assert {s.rid for s in drained} == {s.rid for s in sessions}
            # only the lane-holders replay through prefill
            for s in drained:
                assert s.stats.preemptions == (1 if s.rid in running else 0)
        return [(s.rid, s.out, s.stats.preemptions) for s in drained], sorted(running)

    j, t = _both(gemma, drive)
    assert t == j


def test_failover_reroutes_registered_prefix_sessions(gemma):
    def drive(serve, cfg, model, params):
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=serve.EngineConfig(n_slots=2, max_len=32, prefill_chunk=4, page_size=4),
            n_replicas=2, router="prefix_affinity"))
        prefix = [1, 2, 3, 4]
        cluster.register_prefix(prefix, replica=0)
        sessions = [cluster.submit(prefix + [t], 6) for t in (5, 6, 7)]
        ref = _single_engine_outputs(serve, model, params, [s.prompt for s in sessions],
                                     max_new=6, page_size=4)
        cluster.step()
        drained = cluster.fail_replica(0)  # the prefix owner goes down
        assert drained
        # affinity forgot replica 0: the drained sessions land on the survivor
        # (which has no shared pages for the prefix) and still finish token-exact
        assert all(cluster._placement[s.rid] == 1 for s in drained)
        cluster.run()
        for s in sessions:
            assert s.done and s.out == ref[tuple(s.prompt)]
        assert cluster.replicas[1].engine.metrics.prefix_hits == 0
        return [s.out for s in sessions], _counters(cluster.summary())

    j, t = _both(gemma, drive)
    assert t == j


# ---------------------------------------------------------------------------
# custom routers, configuration checks
# ---------------------------------------------------------------------------
def test_register_router_custom_policy(gemma):
    serve, cfg, model, params = gemma["torch"]

    class _PinToLast(serve.RouterPolicy):
        def place(self, prompt, priority, replicas):
            return max(r.index for r in replicas if r.alive)

    try:
        serve.register_router("pin_to_last", _PinToLast)
        assert serve.ROUTERS["pin_to_last"] is _PinToLast
        assert isinstance(serve.make_router("pin_to_last"), _PinToLast)
        with pytest.raises(ValueError, match="already registered"):
            serve.register_router("pin_to_last", _PinToLast)
        with pytest.raises(ValueError, match="already registered"):
            serve.register_router("least_loaded", _PinToLast)  # stock names stay
        # registered names pass ClusterConfig validation and route for real
        cluster = serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=serve.EngineConfig(n_slots=2, max_len=32, prefill_chunk=4),
            n_replicas=2, router="pin_to_last"))
        s = cluster.submit(_prompts(cfg, 1)[0], 4)
        assert cluster._placement[s.rid] == 1
        cluster.run()
        assert s.done
    finally:
        serve.ROUTERS.pop("pin_to_last", None)
    assert "pin_to_last" not in jserve.ROUTERS  # the packages' registries are their own


def test_register_router_as_decorator_and_protocol_check(gemma):
    serve, _, model, params = gemma["torch"]
    try:
        @serve.register_router("decorated")
        class _Decorated(serve.RouterPolicy):
            def place(self, prompt, priority, replicas):
                return 0

        assert serve.ROUTERS["decorated"] is _Decorated
    finally:
        serve.ROUTERS.pop("decorated", None)
    with pytest.raises(TypeError, match="RouterPolicy protocol"):
        serve.ClusterRouter(model, params, serve.ClusterConfig(
            engine=serve.EngineConfig(n_slots=2, max_len=16)), policy=object())


def test_cluster_config_checks():
    for serve in (tserve, jserve):
        with pytest.raises(ValueError, match="unknown router"):
            serve.ClusterConfig(engine=serve.EngineConfig(n_slots=2, max_len=16), router="x")
        with pytest.raises(ValueError, match="n_replicas"):
            serve.ClusterConfig(engine=serve.EngineConfig(n_slots=2, max_len=16), n_replicas=0)
        with pytest.raises(ValueError, match="heartbeat_timeout"):
            serve.HealthConfig(heartbeat_timeout=0)
    with pytest.raises(ValueError, match="owns device placement"):
        tserve.ClusterConfig(
            engine=tserve.EngineConfig(n_slots=2, max_len=16, mesh=object()), n_replicas=2)
    with pytest.raises(ValueError, match="owns device placement"):
        jserve.ClusterConfig(
            engine=jserve.EngineConfig(
                n_slots=2, max_len=16,
                mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("model",))),
            n_replicas=2)


def test_serve_package_exports_the_references_names():
    assert sorted(tserve.__all__) == sorted(jserve.__all__)
    assert all(hasattr(tserve, n) for n in tserve.__all__)
    from repro_torch import ft

    assert sorted(ft.__all__) == ["ElasticController", "HeartbeatMonitor", "StragglerDetector"]
