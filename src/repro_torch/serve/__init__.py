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

Robustness: per-request deadlines (``submit(deadline_s=)``), a budgeted
requeue path with exponential backoff (``RetryBudgetExceeded``), NaN-guard
lane quarantine, per-op quarantine by the numerics guard
(``EngineConfig.guard``) and graceful cuda->torch degradation.

Not ported yet (ROADMAP.md §1 item 8): the cluster and its router
(``ClusterRouter``, ``ClusterConfig``, ``HealthConfig``, ``Replica``,
``RouterPolicy``, ``RoundRobinPolicy``, ``LeastLoadedPolicy``,
``PrefixAffinityPolicy``, ``ROUTERS``, ``make_router``, ``register_router``,
``replica_meshes``) and the chaos layer (``Fault``, ``FaultPlan``,
``FaultInjector``).  ``ClusterMetrics`` is here already.
"""
from .engine import (
    SERVABLE_FAMILIES,
    EngineConfig,
    ReplicaCrashed,
    RetryBudgetExceeded,
    ServeEngine,
    UnsupportedFamilyError,
)
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
    "SCHEDULERS",
    "SERVABLE_FAMILIES",
    "ClusterMetrics",
    "EngineConfig",
    "EngineMetrics",
    "FCFSScheduler",
    "PageAllocator",
    "PagePoolExhausted",
    "PriorityScheduler",
    "ReplicaCrashed",
    "RequestStats",
    "RetryBudgetExceeded",
    "Scheduler",
    "ServeEngine",
    "Session",
    "SharedPrefix",
    "StaticBatchScheduler",
    "UnsupportedFamilyError",
    "greedy",
    "make_scheduler",
    "temperature_sample",
    "top_k_sample",
]
