"""Cluster scale-out benchmark — the serving sweep over a device-count axis.

Port of ``repro.bench.suites.serving_scaled``, with its record names and
grids.  Where ``serving`` measures one engine, this suite drives
:class:`~repro_torch.serve.cluster.ClusterRouter` across a tensor-parallel ×
data-parallel grid: ``tp`` would shard each replica over ``tp`` devices,
``replicas`` fans requests out data-parallel, and every sweep point reports
the pooled :class:`~repro_torch.serve.metrics.ClusterMetrics` rows (TTFT,
p95 inter-token latency, throughput, slot-weighted occupancy) with ``x`` set
to the point's device count — the scale-out curve.

Points whose ``tp`` exceeds the visible device count are skipped, as the
reference skips them; a ``tp > 1`` point that fits raises, since
tensor-parallel replicas need a process group per replica under one router
(ROADMAP.md §1 item 11b).  A ``failover`` contrast point kills one of two replicas
mid-run and serves the drained sessions to completion on the survivor — its
``requeued_sessions`` metric is the resilience headline.  Replicas on one
card step one after another, so on one card the ``replicas`` axis measures
the router's overhead, not a scale-out.  On a CPU device
``serving_scaled[cuda]`` gives one ``serving_scaled_skipped`` row.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.registry import register
from repro_torch.core.timing import resolve_device

from ._skip import skipped_on_cpu
from .serving import _build_model


def _drive_cluster(cfg, model, params, *, backend, tp, n_replicas, n_slots,
                   prompt_len, out_len, requests, prefill_chunk,
                   page_size=None, router="least_loaded", seed=0,
                   fail_after: int = 0):
    """One measured cluster run: warm-up batch through the same replicas,
    telemetry reset, then the measured batch.  ``fail_after > 0`` fails
    replica 0 after that many measured ticks and lets the survivors finish
    the drained sessions."""
    from repro_torch.serve import ClusterConfig, ClusterRouter, EngineConfig

    cluster = ClusterRouter(model, params, ClusterConfig(
        engine=EngineConfig(
            n_slots=n_slots,
            max_len=prompt_len + out_len + 1,
            prefill_chunk=prefill_chunk,
            page_size=page_size,
            backend=backend,
        ),
        n_replicas=n_replicas,
        tp=tp,
        router=router,
    ))
    rng = np.random.default_rng(seed)

    def batch(n, fail_after=0):
        sessions = [
            cluster.submit(
                [int(t) for t in rng.integers(1, cfg.vocab_size, prompt_len)],
                max_new_tokens=out_len,
            )
            for _ in range(n)
        ]
        if fail_after:
            for _ in range(fail_after):
                cluster.step()
            cluster.fail_replica(0)
        cluster.run(max_ticks=50 * max(n, 1) * out_len)
        done = sum(s.done for s in sessions)
        if done != n:
            raise RuntimeError(f"cluster served {done}/{n} requests")

    batch(min(2, requests))  # warm-up: first calls of each replica's steps
    cluster.reset_metrics()
    batch(requests, fail_after=fail_after)
    return cluster


@register(
    "serving_scaled",
    backends=("cuda", "torch"),
    paper_ref="Ch.1 (inference board scale-out)",
    description="cluster TTFT/latency/throughput over a tp x replicas device sweep",
    quick={"tps": (1,), "replicas": (1, 2), "n_slots": 2, "prompt_len": 8,
           "out_len": 6, "requests": 4, "prefill_chunk": 4,
           "page_sizes": (4,), "failover": True},
    full={"tps": (1, 2, 4), "replicas": (1, 2), "n_slots": 2, "prompt_len": 8,
          "out_len": 8, "requests": 8, "prefill_chunk": 4,
          "page_sizes": (4,), "failover": True},
)
def bench_serving_scaled(tps=(1,), replicas=(1, 2), n_slots=2, prompt_len=8,
                         out_len=6, requests=4, prefill_chunk=4,
                         page_sizes=(4,), router="least_loaded",
                         backend="torch", failover=True, device="cuda") -> list:
    """Each (tp, replicas) point drives a fresh cluster over seeded prompts
    — dense KV plus a paged twin per entry of ``page_sizes`` — and reports
    its pooled cluster rows with ``x`` = devices used.  A warm-up pass per
    point keeps first-call costs out of TTFT."""
    points = len(tps) * len(replicas) * (1 + len(page_sizes)) + bool(failover)
    skipped = skipped_on_cpu("serving_scaled", points, backend, device)
    if skipped:
        return skipped
    dev = resolve_device(device)
    cfg, model, params = _build_model(dev)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    recs = []
    for tp in tps:
        if tp > n_dev:
            continue  # full grid point; needs more devices than are visible
        for nr in replicas:
            devices_used = min(tp * nr, n_dev)
            for ps in (None,) + tuple(page_sizes):
                cluster = _drive_cluster(
                    cfg, model, params, backend=backend, tp=tp, n_replicas=nr,
                    n_slots=n_slots, prompt_len=prompt_len, out_len=out_len,
                    requests=requests, prefill_chunk=prefill_chunk,
                    page_size=ps, router=router,
                )
                prefix = f"serving_scaled_tp{tp}_r{nr}" + (f"_ps{ps}" if ps else "")
                recs.extend(cluster.to_records(
                    "serving_scaled", prefix, x=devices_used
                ))
    if failover and min(tps) <= n_dev:
        cluster = _drive_cluster(
            cfg, model, params, backend=backend, tp=min(tps), n_replicas=2,
            n_slots=n_slots, prompt_len=prompt_len, out_len=out_len,
            requests=requests, prefill_chunk=prefill_chunk,
            page_size=page_sizes[0] if page_sizes else None, router=router,
            fail_after=2,
        )
        recs.extend(cluster.to_records(
            "serving_scaled", "serving_scaled_failover",
            x=min(min(tps) * 2, n_dev),
        ))
    return recs
