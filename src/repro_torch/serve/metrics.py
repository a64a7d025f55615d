"""Engine instrumentation: every tick is measured, every request traced.

Port of ``repro.serve.metrics``: host code, ported whole.

The engine feeds :class:`EngineMetrics` wall-clock samples (tick duration,
prefill-chunk duration, slot occupancy, KV-page-pool occupancy) plus each
finished session's :class:`~repro_torch.serve.session.RequestStats`; ``summary()``
distills the paper-style sustained-load numbers (TTFT, per-token latency
percentiles, throughput, occupancy/concurrency, page occupancy, preemption
and shared-prefix-hit counts) and ``to_records()`` emits them in the
schema-v1 record format the bench subsystem stores and gates (the
``page_occupancy`` row appears only for paged engines).

:class:`ClusterMetrics` is the one-level-up view: it pools per-replica
``EngineMetrics`` into a single cluster summary (request samples pooled,
throughput counters summed, occupancy weighted by each replica's tick
coverage) and adds the router-level counters — replica failures and
requeued sessions — that no single engine can see.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.timing import percentile

from .session import Session


class EngineMetrics:
    """Accumulates one engine's serving telemetry.

    ``n_pages`` is 0 for dense engines; paged engines report page-pool
    occupancy per tick (:meth:`record_pages`), recompute preemptions
    (:meth:`record_preemption`), and shared-prefix cache hits
    (:meth:`record_prefix_hit`) on top of the common tick/request telemetry.
    """

    def __init__(self, n_slots: int, n_pages: int = 0):
        self.n_slots = n_slots
        self.n_pages = n_pages  # KV page pool size (0: dense engine)
        self.tick_s: list = []  # full step() wall-clock
        self.decode_s: list = []  # decode-step portion of each tick
        self.occupancy: list = []  # active slots at each decode tick
        self.prefill_s: list = []  # per prefill flush (all chunks)
        self.prefill_tokens = 0  # prompt tokens prefilled
        self.prefill_requests = 0
        self.ttft_s: list = []  # per finished request
        self.token_latency_s: list = []  # inter-token gaps, pooled
        self.generated_tokens = 0
        self.finished = 0
        self.cancelled = 0
        self.pages_used: list = []  # pool pages in use at each decode tick
        self.preemptions = 0  # lanes evicted to free pages
        self.prefix_hits = 0  # admissions that forked a shared prefix
        self.prefix_tokens_reused = 0  # prompt tokens NOT re-prefilled
        # robustness counters (see docs/robustness.md)
        self.deadline_expired = 0  # sessions finished with reason="deadline"
        self.deadline_tokens = 0  # tokens generated for deadline-missed sessions
        self.requeues = 0  # budgeted requeues (preempt/drain/quarantine/failover)
        self.quarantines = 0  # lanes benched after non-finite logits
        self.nan_events = 0  # decode/prefill rows that failed the NaN guard
        self.degradations = 0  # cuda -> torch backend fallbacks
        self.tick_budget_exhausted = 0  # run() returns with work still pending
        # numerics-guard counters (docs/robustness.md#numerics-guard)
        self.guard_checks = 0  # compiled-step outputs shadow-checked
        self.drift_events = 0  # shadow checks that failed the tolerance ladder
        self.op_degradations = 0  # kernel ops quarantined to the oracle
        self.op_revivals = 0  # quarantined ops re-probed clean and revived

    # -- engine hooks ------------------------------------------------------
    def record_tick(self, seconds: float, decode_seconds: float, n_active: int) -> None:
        self.tick_s.append(seconds)
        self.decode_s.append(decode_seconds)
        self.occupancy.append(n_active)

    def record_prefill(self, seconds: float, n_tokens: int, n_requests: int) -> None:
        self.prefill_s.append(seconds)
        self.prefill_tokens += n_tokens
        self.prefill_requests += n_requests

    def record_pages(self, pages_in_use: int) -> None:
        self.pages_used.append(pages_in_use)

    def record_preemption(self) -> None:
        self.preemptions += 1

    def record_prefix_hit(self, tokens_reused: int) -> None:
        self.prefix_hits += 1
        self.prefix_tokens_reused += tokens_reused

    def record_requeue(self) -> None:
        self.requeues += 1

    def record_quarantine(self) -> None:
        self.quarantines += 1

    def record_nan_event(self, n_lanes: int = 1) -> None:
        self.nan_events += n_lanes

    def record_degradation(self) -> None:
        self.degradations += 1

    def record_tick_budget_exhausted(self) -> None:
        self.tick_budget_exhausted += 1

    def record_guard_check(self) -> None:
        self.guard_checks += 1

    def record_drift_event(self) -> None:
        self.drift_events += 1

    def record_op_degradation(self, n_ops: int = 1) -> None:
        self.op_degradations += n_ops

    def record_op_revival(self) -> None:
        self.op_revivals += 1

    def record_finished(self, session: Session) -> None:
        if session.finish_reason == "cancelled":
            self.cancelled += 1
            return
        self.finished += 1
        self.generated_tokens += len(session.out)
        if session.finish_reason == "deadline":
            # still a served request, but its tokens missed the SLA —
            # excluded from goodput, tracked separately
            self.deadline_expired += 1
            self.deadline_tokens += len(session.out)
        if session.stats.ttft_s is not None:
            self.ttft_s.append(session.stats.ttft_s)
        self.token_latency_s.extend(session.stats.token_latencies_s)

    # -- derived -----------------------------------------------------------
    def summary(self) -> dict:
        """Sustained-load summary; times in ms, rates in tokens/s."""
        total_s = sum(self.tick_s) + sum(self.prefill_s)
        n_t = len(self.ttft_s)
        occ = (
            sum(self.occupancy) / (len(self.occupancy) * self.n_slots)
            if self.occupancy
            else 0.0
        )
        page_occ = (
            sum(self.pages_used) / (len(self.pages_used) * self.n_pages)
            if self.pages_used and self.n_pages
            else 0.0
        )
        return {
            "requests": self.finished,
            "cancelled": self.cancelled,
            "generated_tokens": self.generated_tokens,
            "prefill_tokens": self.prefill_tokens,
            "ticks": len(self.tick_s),
            "total_s": total_s,
            "throughput_tok_s": self.generated_tokens / total_s if total_s else 0.0,
            "prefill_tok_s": (
                self.prefill_tokens / sum(self.prefill_s) if self.prefill_s else 0.0
            ),
            "ttft_ms_mean": (sum(self.ttft_s) / n_t * 1e3) if n_t else float("nan"),
            "ttft_ms_p50": percentile(self.ttft_s, 50) * 1e3,
            "ttft_ms_p95": percentile(self.ttft_s, 95) * 1e3,
            "tok_latency_ms_p50": percentile(self.token_latency_s, 50) * 1e3,
            "tok_latency_ms_p95": percentile(self.token_latency_s, 95) * 1e3,
            "occupancy": occ,
            # mean concurrently-active lanes: the absolute twin of
            # ``occupancy`` — comparable across engines with different
            # n_slots (the paged-vs-dense equal-memory contrast)
            "concurrency": occ * self.n_slots,
            "page_occupancy": page_occ,
            "pages_peak": max(self.pages_used, default=0),
            "preemptions": self.preemptions,
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            # goodput: tokens generated for sessions that met their deadline
            # (== generated for engines without deadlines)
            "goodput_tokens": self.generated_tokens - self.deadline_tokens,
            "goodput_tok_s": (
                (self.generated_tokens - self.deadline_tokens) / total_s
                if total_s else 0.0
            ),
            "deadline_expired": self.deadline_expired,
            "requeues": self.requeues,
            "quarantines": self.quarantines,
            "nan_events": self.nan_events,
            "degradations": self.degradations,
            "tick_budget_exhausted": self.tick_budget_exhausted,
            "guard_checks": self.guard_checks,
            "drift_events": self.drift_events,
            "op_degradations": self.op_degradations,
            "op_revivals": self.op_revivals,
        }

    def to_records(self, benchmark: str, prefix: str, x=None) -> list:
        """Schema-v1 rows for one engine run: TTFT, per-token latency
        percentiles, throughput, and slot occupancy."""
        from repro_torch.bench.schema import BenchRecord

        s = self.summary()
        shared = {
            "requests": s["requests"],
            "generated_tokens": s["generated_tokens"],
            "ticks": s["ticks"],
        }
        rows = [
            BenchRecord(
                name=f"{prefix}_ttft",
                benchmark=benchmark,
                x=x,
                value=s["ttft_ms_mean"],
                unit="ms",
                metrics={**shared, "p50": s["ttft_ms_p50"], "p95": s["ttft_ms_p95"]},
                info="time to first token (queue + prefill + sample)",
            ),
            BenchRecord(
                name=f"{prefix}_tok_latency_p50",
                benchmark=benchmark,
                x=x,
                value=s["tok_latency_ms_p50"],
                unit="ms",
                metrics=shared,
                info="median inter-token latency",
            ),
            BenchRecord(
                name=f"{prefix}_tok_latency_p95",
                benchmark=benchmark,
                x=x,
                value=s["tok_latency_ms_p95"],
                unit="ms",
                metrics=shared,
                info="p95 inter-token latency",
            ),
            BenchRecord(
                name=f"{prefix}_throughput",
                benchmark=benchmark,
                x=x,
                value=s["throughput_tok_s"],
                unit="tok/s",
                better="higher",
                metrics={**shared, "prefill_tok_s": s["prefill_tok_s"]},
                info="generated tokens / engine wall-clock",
            ),
            BenchRecord(
                name=f"{prefix}_occupancy",
                benchmark=benchmark,
                x=x,
                value=s["occupancy"],
                unit="frac",
                better="info",
                metrics=shared,
                info=f"mean active slots / {self.n_slots}",
            ),
            BenchRecord(
                name=f"{prefix}_concurrency",
                benchmark=benchmark,
                x=x,
                value=s["concurrency"],
                unit="slots",
                better="higher",
                metrics={**shared, "n_slots": self.n_slots},
                info="mean concurrently-active lanes (absolute slot occupancy)",
            ),
            BenchRecord(
                name=f"{prefix}_goodput",
                benchmark=benchmark,
                x=x,
                value=s["goodput_tok_s"],
                unit="tok/s",
                better="higher",
                metrics={
                    **shared,
                    "goodput_tokens": s["goodput_tokens"],
                    "deadline_expired": s["deadline_expired"],
                },
                info="deadline-met tokens / engine wall-clock",
            ),
            BenchRecord(
                name=f"{prefix}_faults",
                benchmark=benchmark,
                x=x,
                value=float(
                    s["requeues"] + s["quarantines"] + s["nan_events"]
                    + s["degradations"] + s["deadline_expired"]
                    + s["drift_events"] + s["op_degradations"]
                ),
                unit="count",
                better="info",
                metrics={
                    **shared,
                    "requeues": s["requeues"],
                    "quarantines": s["quarantines"],
                    "nan_events": s["nan_events"],
                    "degradations": s["degradations"],
                    "deadline_expired": s["deadline_expired"],
                    "preemptions": s["preemptions"],
                    "tick_budget_exhausted": s["tick_budget_exhausted"],
                    "guard_checks": s["guard_checks"],
                    "drift_events": s["drift_events"],
                    "op_degradations": s["op_degradations"],
                    "op_revivals": s["op_revivals"],
                },
                info="fault-handling events (requeue/quarantine/nan/degrade/deadline/drift)",
            ),
        ]
        if self.n_pages:
            rows.append(
                BenchRecord(
                    name=f"{prefix}_page_occupancy",
                    benchmark=benchmark,
                    x=x,
                    value=s["page_occupancy"],
                    unit="frac",
                    better="info",
                    metrics={
                        **shared,
                        "n_pages": self.n_pages,
                        "pages_peak": s["pages_peak"],
                        "preemptions": s["preemptions"],
                        "prefix_hits": s["prefix_hits"],
                        "prefix_tokens_reused": s["prefix_tokens_reused"],
                    },
                    info=f"mean KV pages in use / {self.n_pages}",
                )
            )
        return rows


class ClusterMetrics:
    """Router-level telemetry pooled over per-replica :class:`EngineMetrics`.

    Request-level samples (TTFT, inter-token gaps) are pooled across
    replicas — a cluster percentile is over *all* finished requests, not a
    mean of per-replica percentiles.  Occupancy is slot-weighted: each
    replica contributes ``sum(occ samples)`` over ``ticks * n_slots``, so a
    busy replica with more ticks weighs more — a naive mean of per-replica
    occupancies would not.  Throughput uses the router's own wall clock
    (``wall_s``) when set: in-process replicas step sequentially, so summing
    per-replica engine time would double-count the same wall interval.

    The router itself records what engines can't see: replica failures and
    the sessions drained + requeued onto surviving replicas.
    """

    def __init__(self):
        self.failures = 0  # replicas failed over the cluster's lifetime
        self.requeued_sessions = 0  # sessions drained off a failed replica
        self.requeued_tokens = 0  # generated tokens carried through requeue
        self.routed = 0  # submit() placements (first placement only)
        self.wall_s = 0.0  # router-measured serving wall-clock
        # robustness counters (see docs/robustness.md)
        self.failovers: dict = {}  # failover reason -> count (manual/heartbeat/...)
        self.failover_skipped = 0  # detections left unactioned (last live replica)
        self.half_opens = 0  # cooled-down replicas probed back in
        self.revivals = 0  # half-open probes that fully closed the breaker
        self.live_replica_ticks = 0  # sum over ticks of live replicas
        self.total_replica_ticks = 0  # sum over ticks of configured replicas
        self.tick_budget_exhausted = 0  # run() returns with work still pending

    def record_route(self) -> None:
        self.routed += 1

    def record_failure(self, drained: Sequence[Session], reason: str = "manual") -> None:
        self.failures += 1
        self.failovers[reason] = self.failovers.get(reason, 0) + 1
        self.requeued_sessions += len(drained)
        self.requeued_tokens += sum(len(s.out) for s in drained)

    def record_liveness(self, n_alive: int, n_total: int) -> None:
        """Per-tick availability sample: live replicas out of configured."""
        self.live_replica_ticks += n_alive
        self.total_replica_ticks += n_total

    def record_failover_skipped(self) -> None:
        self.failover_skipped += 1

    def record_half_open(self) -> None:
        self.half_opens += 1

    def record_revival(self) -> None:
        self.revivals += 1

    def record_tick_budget_exhausted(self) -> None:
        self.tick_budget_exhausted += 1

    # -- derived -----------------------------------------------------------
    def summary(self, parts: Sequence[EngineMetrics]) -> dict:
        """Cluster summary over per-replica engine metrics (times in ms)."""
        ttft = [t for m in parts for t in m.ttft_s]
        gaps = [g for m in parts for g in m.token_latency_s]
        generated = sum(m.generated_tokens for m in parts)
        engine_s = sum(sum(m.tick_s) + sum(m.prefill_s) for m in parts)
        total_s = self.wall_s or engine_s
        occ_num = sum(sum(m.occupancy) for m in parts)
        occ_den = sum(len(m.occupancy) * m.n_slots for m in parts)
        prefill_s = sum(sum(m.prefill_s) for m in parts)
        page_num = sum(sum(m.pages_used) for m in parts)
        page_den = sum(len(m.pages_used) * m.n_pages for m in parts if m.n_pages)
        n_t = len(ttft)
        return {
            "replicas": len(parts),
            "requests": sum(m.finished for m in parts),
            "cancelled": sum(m.cancelled for m in parts),
            "generated_tokens": generated,
            "prefill_tokens": sum(m.prefill_tokens for m in parts),
            "ticks": sum(len(m.tick_s) for m in parts),
            "total_s": total_s,
            "throughput_tok_s": generated / total_s if total_s else 0.0,
            "prefill_tok_s": (
                sum(m.prefill_tokens for m in parts) / prefill_s
                if prefill_s else 0.0
            ),
            "ttft_ms_mean": (sum(ttft) / n_t * 1e3) if n_t else float("nan"),
            "ttft_ms_p50": percentile(ttft, 50) * 1e3,
            "ttft_ms_p95": percentile(ttft, 95) * 1e3,
            "tok_latency_ms_p50": percentile(gaps, 50) * 1e3,
            "tok_latency_ms_p95": percentile(gaps, 95) * 1e3,
            "occupancy": occ_num / occ_den if occ_den else 0.0,
            # mean concurrently-active lanes summed over replicas: the
            # cluster-wide twin of EngineMetrics.concurrency
            "concurrency": sum(m.summary()["concurrency"] for m in parts),
            "page_occupancy": page_num / page_den if page_den else 0.0,
            # per-replica pools are disjoint, so the cluster-wide KV
            # footprint peak is the sum of per-replica peaks
            "pages_peak": sum(max(m.pages_used, default=0) for m in parts),
            "preemptions": sum(m.preemptions for m in parts),
            "prefix_hits": sum(m.prefix_hits for m in parts),
            "prefix_tokens_reused": sum(m.prefix_tokens_reused for m in parts),
            "routed": self.routed,
            "failures": self.failures,
            "requeued_sessions": self.requeued_sessions,
            "requeued_tokens": self.requeued_tokens,
            # robustness roll-up: engine fault counters summed, plus the
            # router-level availability/failover view
            "goodput_tokens": sum(m.summary()["goodput_tokens"] for m in parts),
            "goodput_tok_s": (
                sum(m.summary()["goodput_tokens"] for m in parts) / total_s
                if total_s else 0.0
            ),
            "deadline_expired": sum(m.deadline_expired for m in parts),
            "requeues": sum(m.requeues for m in parts),
            "quarantines": sum(m.quarantines for m in parts),
            "nan_events": sum(m.nan_events for m in parts),
            "degradations": sum(m.degradations for m in parts),
            "guard_checks": sum(m.guard_checks for m in parts),
            "drift_events": sum(m.drift_events for m in parts),
            "op_degradations": sum(m.op_degradations for m in parts),
            "op_revivals": sum(m.op_revivals for m in parts),
            "failovers": dict(self.failovers),
            "failover_skipped": self.failover_skipped,
            "half_opens": self.half_opens,
            "revivals": self.revivals,
            # fraction of replica-ticks with the replica alive (1.0 when no
            # liveness samples were recorded, i.e. health monitoring off)
            "availability": (
                self.live_replica_ticks / self.total_replica_ticks
                if self.total_replica_ticks else 1.0
            ),
            "tick_budget_exhausted": self.tick_budget_exhausted,
        }

    def to_records(
        self,
        parts: Sequence[EngineMetrics],
        benchmark: str,
        prefix: str,
        x=None,
    ) -> list:
        """Schema-v1 rows for one cluster run (pooled-percentile semantics)."""
        from repro_torch.bench.schema import BenchRecord

        s = self.summary(parts)
        shared = {
            "replicas": s["replicas"],
            "requests": s["requests"],
            "generated_tokens": s["generated_tokens"],
            "failures": s["failures"],
            "requeued_sessions": s["requeued_sessions"],
        }
        return [
            BenchRecord(
                name=f"{prefix}_ttft",
                benchmark=benchmark,
                x=x,
                value=s["ttft_ms_mean"],
                unit="ms",
                metrics={**shared, "p50": s["ttft_ms_p50"], "p95": s["ttft_ms_p95"]},
                info="cluster TTFT pooled over all replicas",
            ),
            BenchRecord(
                name=f"{prefix}_tok_latency_p95",
                benchmark=benchmark,
                x=x,
                value=s["tok_latency_ms_p95"],
                unit="ms",
                metrics={**shared, "p50": s["tok_latency_ms_p50"]},
                info="p95 inter-token latency pooled over all replicas",
            ),
            BenchRecord(
                name=f"{prefix}_throughput",
                benchmark=benchmark,
                x=x,
                value=s["throughput_tok_s"],
                unit="tok/s",
                better="higher",
                metrics={**shared, "total_s": s["total_s"]},
                info="cluster generated tokens / router wall-clock",
            ),
            BenchRecord(
                name=f"{prefix}_occupancy",
                benchmark=benchmark,
                x=x,
                value=s["occupancy"],
                unit="frac",
                better="info",
                metrics={**shared, "concurrency": s["concurrency"]},
                info="slot-weighted mean occupancy across replicas",
            ),
            BenchRecord(
                name=f"{prefix}_goodput",
                benchmark=benchmark,
                x=x,
                value=s["goodput_tok_s"],
                unit="tok/s",
                better="higher",
                metrics={
                    **shared,
                    "goodput_tokens": s["goodput_tokens"],
                    "deadline_expired": s["deadline_expired"],
                },
                info="deadline-met tokens / router wall-clock",
            ),
            BenchRecord(
                name=f"{prefix}_availability",
                benchmark=benchmark,
                x=x,
                value=s["availability"],
                unit="frac",
                better="higher",
                metrics={
                    **shared,
                    # record metrics are numeric: the by-reason breakdown
                    # stays in summary()["failovers"]
                    "failovers": sum(s["failovers"].values()),
                    "failover_skipped": s["failover_skipped"],
                    "half_opens": s["half_opens"],
                    "revivals": s["revivals"],
                },
                info="live replica-ticks / configured replica-ticks",
            ),
            BenchRecord(
                name=f"{prefix}_faults",
                benchmark=benchmark,
                x=x,
                value=float(
                    s["requeues"] + s["quarantines"] + s["nan_events"]
                    + s["degradations"] + s["deadline_expired"] + s["failures"]
                    + s["drift_events"] + s["op_degradations"]
                ),
                unit="count",
                better="info",
                metrics={
                    **shared,
                    "requeues": s["requeues"],
                    "quarantines": s["quarantines"],
                    "nan_events": s["nan_events"],
                    "degradations": s["degradations"],
                    "deadline_expired": s["deadline_expired"],
                    "failovers": sum(s["failovers"].values()),
                    "tick_budget_exhausted": s["tick_budget_exhausted"],
                    "guard_checks": s["guard_checks"],
                    "drift_events": s["drift_events"],
                    "op_degradations": s["op_degradations"],
                    "op_revivals": s["op_revivals"],
                },
                info="cluster fault-handling events (incl. replica failovers)",
            ),
        ]
