"""Tensor-parallel serving replicas: 2 replicas × tp 2 under one router,
four gloo CPU ranks, and the rank group they run on.

- The streams of a cluster of tensor-parallel replicas
  (``ClusterConfig(tp=2, devices=("cpu",) * 4)``) equal one engine's and
  the tp-1 cluster's, dense and paged, for gemma-2b ``reduced()`` (one KV
  head, kept whole) and qwen2.5-14b ``reduced()`` (2 KV heads, split).
- ``fail_replica`` mid-run drains a replica's sessions and the survivor
  resumes them token-exact; so does a rank that raises or dies mid-run,
  failed over by the health monitor or by hand.
- The seed-7 chaos plan with health monitoring on finishes every request.
- ``launch.serve --replicas 2 --tp 2 --device cpu`` serves and prints its
  ``cluster:`` line.
- ``dist.RankGroup`` keeps its ranks' state between calls, and a rank that
  raises fails the call and closes the group.
"""
from functools import lru_cache

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist import RankGroup
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build_model
from repro_torch.serve import (ClusterConfig, ClusterRouter, EngineConfig, FaultInjector,
                               FaultPlan, HealthConfig, ServeEngine, replica_meshes)
from repro_torch.serve.engine import ReplicaCrashed
from repro_torch.serve.replica_group import TensorParallelReplica

import torch_dist_workers as workers

PROMPTS = [[1 + (i % 5), 2, 3 + i % 7, 4 + i] for i in range(6)]
MAX_NEW = 6
RANKS = ("cpu",) * 4
NAMES = ("gemma-2b", "qwen2.5-14b")


@lru_cache(maxsize=None)
def _model(name):
    cfg = get_config(name).reduced()
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _engine_cfg(page_size=None):
    return EngineConfig(n_slots=2, max_len=32, prefill_chunk=4, page_size=page_size)


@lru_cache(maxsize=None)
def _one_engine(name, page_size):
    _, model, params = _model(name)
    eng = ServeEngine(model, params, _engine_cfg(page_size))
    sessions = [eng.submit(p, MAX_NEW) for p in PROMPTS]
    eng.run()
    return [s.out for s in sessions]


def _cluster(name, tp, page_size=None, **kw):
    _, model, params = _model(name)
    return ClusterRouter(model, params, ClusterConfig(
        engine=_engine_cfg(page_size), n_replicas=2, tp=tp,
        devices=RANKS if tp > 1 else None, **kw))


@pytest.mark.parametrize("name,page_size", [(n, ps) for n in NAMES for ps in (None, 4)])
def test_tp_replicas_stream_as_one_engine_and_the_tp1_cluster(name, page_size):
    want = _one_engine(name, page_size)
    streams = {}
    for tp in (1, 2):
        cluster = _cluster(name, tp, page_size)
        try:
            sessions = [cluster.submit(p, MAX_NEW) for p in PROMPTS]
            cluster.run()
            streams[tp] = [s.out for s in sessions]
            assert all(s.finish_reason == "max_new_tokens" for s in sessions)
            summary = cluster.summary()
            assert summary["tp"] == tp and summary["requests"] == len(PROMPTS)
            if tp == 2:
                assert all(isinstance(r.engine, TensorParallelReplica) for r in cluster.replicas)
                assert [r.mesh for r in cluster.replicas] == [(torch.device("cpu"),) * 2] * 2
                assert [r["requests"] for r in summary["per_replica"]] == [3, 3]
        finally:
            cluster.close()
    assert streams[2] == streams[1] == want


def test_fail_replica_requeues_token_exact():
    want = _one_engine("qwen2.5-14b", None)
    cluster = _cluster("qwen2.5-14b", 2)
    try:
        seen = {}
        sessions = [cluster.submit(p, MAX_NEW, on_token=lambda s, t: seen.setdefault(
            s.rid, []).append(t)) for p in PROMPTS]
        for _ in range(3):
            cluster.step()
        drained = cluster.fail_replica(0)
        assert drained and any(s.out for s in drained)  # some mid-stream
        cluster.run()
        assert [s.out for s in sessions] == want
        assert all(seen[s.rid] == s.out for s in sessions)  # streamed once each
        assert cluster.metrics.requeued_sessions == len(drained)
        assert not cluster.replicas[0].alive and cluster.replicas[0].engine.slots == [None] * 2
    finally:
        cluster.close()


@pytest.mark.parametrize("how,health", [("raise", True), ("exit", False)])
def test_a_failing_rank_fails_its_replica_over_token_exact(how, health):
    """A rank of replica 0 raises (or its process ends) at its third step:
    the group closes, the replica counts as crashed, and it is failed over
    by the heartbeat monitor (health on) or by ``fail_replica`` after the
    tick raises ``ReplicaCrashed`` (health off); the survivor resumes every
    stream token-exact from the caller's own sessions."""
    want = _one_engine("qwen2.5-14b", None)
    cluster = _cluster("qwen2.5-14b", 2, **(
        {"health": HealthConfig(straggler=False)} if health else {}))
    try:
        seen = {}
        sessions = [cluster.submit(p, MAX_NEW, on_token=lambda s, t: seen.setdefault(
            s.rid, []).append(t)) for p in PROMPTS]
        lost = cluster.replicas[0].engine
        assert lost.group.call(workers.fail_engine_step, 1, 3, how) == [0, 1]
        if health:
            cluster.run()
            failovers = dict(cluster.metrics.failovers)
            assert failovers.pop("heartbeat") == 1
            assert set(failovers) <= {"probe"}  # a half-open probe of lost ranks fails
        else:
            with pytest.raises(ReplicaCrashed, match="ranks are gone"):
                cluster.run()
            drained = cluster.fail_replica(0)
            assert drained and any(s.out for s in drained)  # some mid-stream
            cluster.run()
            assert cluster.metrics.failovers == {"manual": 1}
        assert [s.out for s in sessions] == want
        assert all(s.finish_reason == "max_new_tokens" for s in sessions)
        assert all(seen[s.rid] == s.out for s in sessions)  # streamed once each
        assert lost.lost is not None and lost.crashed and lost.group.closed
        assert not cluster.replicas[0].alive and lost.slots == [None] * 2
        assert cluster.summary()["requests"] == len(PROMPTS)
    finally:
        cluster.close()


def test_chaos_plan_with_health_finishes_every_request():
    cluster = _cluster("gemma-2b", 2, health=HealthConfig())
    try:
        sessions = [cluster.submit(p, MAX_NEW) for p in PROMPTS * 2]
        plan = FaultPlan.random(7, n_faults=4, n_replicas=2)
        injector = FaultInjector(plan, cluster)
        finished = injector.run()
        assert len(finished) == len(sessions)
        assert all(s.finish_reason == "max_new_tokens" and len(s.out) == MAX_NEW
                   for s in sessions)
        assert injector.summary()["applied"]["crash"] == 1
    finally:
        cluster.close()


def test_launcher_serves_tp_replicas(capsys):
    finished = tlaunch.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                             "--requests", "4", "--max-new", "5", "--replicas", "2",
                             "--tp", "2"])
    out = capsys.readouterr().out
    assert len(finished) == 4 and all(s.finish_reason == "max_new_tokens" for s in finished)
    assert "cluster: 2 replica(s) x tp=2" in out and "served 4/4 requests" in out


def test_replica_placement_follows_the_reference():
    """Disjoint groups when replicas × tp fit the devices, wrapping
    otherwise; ranks stand in for devices, so one card can host them."""
    four = [torch.device("cpu"), torch.device("meta"), torch.device("cuda", 0),
            torch.device("cuda", 1)]
    assert replica_meshes(2, 2, four) == [tuple(four[:2]), tuple(four[2:])]
    assert replica_meshes(3, 2, four) == [tuple(four[:2]), tuple(four[2:]), tuple(four[:2])]
    assert replica_meshes(2, 2, ["cuda"] * 4) == [(torch.device("cuda"),) * 2] * 2
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        replica_meshes(1, 3, four[:2])


def test_rank_group_keeps_state_and_closes_on_a_failure():
    with RankGroup(2, device="cpu", timeout=120) as group:
        assert group.backend == "gloo"
        assert group.call(workers.remember, 3.0) == [9.0, 9.0]
        assert group.call(workers.recall) == [(3.0, 1), (6.0, 1)]
    group = RankGroup(2, device="cpu", timeout=120)
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\\n)*on purpose"):
        group.call(workers.fail_on_rank, 1)
    assert all(not p.is_alive() for p in group._procs)
    with pytest.raises(RuntimeError, match="closed"):
        group.call(workers.recall)
