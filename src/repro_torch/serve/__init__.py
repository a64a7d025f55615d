"""Serving substrate: pluggable batched engine with paged or dense KV.

Port of ``repro.serve``.  ``ServeEngine`` + ``EngineConfig`` drive a fixed
slot grid with one decode step per tick and chunked batched prefill;
admission order is a swappable ``Scheduler`` (FCFS / priority /
static-batch, or user-supplied); ``submit()`` returns a streaming
``Session`` handle; ``EngineMetrics`` emits schema-v1 serving records (TTFT,
latency percentiles, throughput).  Setting ``EngineConfig.page_size``
switches the KV layout from dense per-slot regions to a global refcounted
page pool (``PageAllocator``) with continuous batching, recompute
preemption, and copy-on-write shared prefixes
(``ServeEngine.register_prefix``) — see docs/serving.md.

``ClusterRouter`` + ``ClusterConfig`` scale the same surface out: a
data-parallel replica router with pluggable placement policies (extensible
via ``register_router``), pooled ``ClusterMetrics``, and replica-failure
drain/requeue.  A tensor-parallel replica (``ClusterConfig.tp > 1``) is a
group of ranks, one process each, under the one router
(``TensorParallelReplica``); one tensor-parallel engine runs with
``EngineConfig.mesh``.

Robustness: per-request deadlines (``submit(deadline_s=)``), a budgeted
requeue path with exponential backoff (``RetryBudgetExceeded``), NaN-guard
lane quarantine, per-op quarantine by the numerics guard
(``EngineConfig.guard``), graceful cuda->torch degradation, health-driven
failover with a circuit breaker (``ClusterConfig.health`` /
``HealthConfig``), and the deterministic chaos layer in
``repro_torch.serve.faults`` (``FaultPlan`` / ``FaultInjector``).
"""
from .cluster import (
    ROUTERS,
    ClusterConfig,
    ClusterRouter,
    HealthConfig,
    LeastLoadedPolicy,
    PrefixAffinityPolicy,
    Replica,
    RoundRobinPolicy,
    RouterPolicy,
    make_router,
    register_router,
    replica_meshes,
)
from .engine import (
    SERVABLE_FAMILIES,
    EngineConfig,
    ReplicaCrashed,
    RetryBudgetExceeded,
    ServeEngine,
    UnsupportedFamilyError,
)
from .faults import Fault, FaultInjector, FaultPlan
from .metrics import ClusterMetrics, EngineMetrics
from .paging import PageAllocator, PagePoolExhausted, SharedPrefix
from .sampler import greedy, temperature_sample, top_k_sample
from .scheduler import (
    SCHEDULERS,
    FCFSScheduler,
    PriorityScheduler,
    Scheduler,
    StaticBatchScheduler,
    make_scheduler,
)
from .session import RequestStats, Session

__all__ = [
    "ROUTERS",
    "SCHEDULERS",
    "SERVABLE_FAMILIES",
    "ClusterConfig",
    "ClusterMetrics",
    "ClusterRouter",
    "EngineConfig",
    "EngineMetrics",
    "FCFSScheduler",
    "Fault",
    "FaultInjector",
    "FaultPlan",
    "HealthConfig",
    "LeastLoadedPolicy",
    "PageAllocator",
    "PagePoolExhausted",
    "PrefixAffinityPolicy",
    "PriorityScheduler",
    "Replica",
    "ReplicaCrashed",
    "RequestStats",
    "RetryBudgetExceeded",
    "RoundRobinPolicy",
    "RouterPolicy",
    "Scheduler",
    "ServeEngine",
    "Session",
    "SharedPrefix",
    "StaticBatchScheduler",
    "UnsupportedFamilyError",
    "greedy",
    "make_router",
    "make_scheduler",
    "register_router",
    "replica_meshes",
    "temperature_sample",
    "top_k_sample",
]
