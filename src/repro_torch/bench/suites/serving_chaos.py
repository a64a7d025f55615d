"""Chaos serving benchmark — availability and goodput under injected faults.

Port of ``repro.bench.suites.serving_chaos``, with its record names, plans
and contracts.

The paper's methodology is contrast under controlled stress (the same
workload measured clean vs. thermally throttled, §4.5); this suite restates
that for the hardened serving stack.  One seeded workload runs twice against
a health-monitored two-replica cluster:

- **clean** (``serving_chaos_clean_*``): no faults — the baseline rows,
- **faulted** (``serving_chaos_faulted_*``): the same prompts driven through
  a fixed :class:`~repro_torch.serve.faults.FaultPlan` that crashes a replica,
  dilates another's step times by the §4.5 throttle signature (straggler
  failover), raises one simulated kernel fault (graceful ``torch``
  degradation, ``EngineConfig.degrade``), poisons one lane's logits with NaN (quarantine + retry),
  and steals free KV pages (admission pressure).

On the ``cuda`` backend two **guarded** legs run the same workload with the
numerics guard armed (``EngineConfig(guard="shadow")``), each inside
:func:`repro_torch.kernels.guard.isolated` (at the H100's tolerances on the
card) so intentional injections never leak into the process-global guard
state:

- **guarded-clean**: shadow-checks every step against the ``torch``
  oracle and must report *zero* drift and token-exact output — the
  false-positive gate for the tolerance ladder,
- **guarded-faulted** (``serving_chaos_guarded_*``): an op-targeted
  :func:`_guard_fault_plan` injects a seeded numeric drift on ``matmul``
  and a simulated kernel fault on ``flash_attention``; the guard must
  detect every injected drift call, quarantine exactly those two ops (no
  whole-engine degradation), revive them once the faults expire, and still
  emit tokens exactly matching the clean run.  The half-open probes that
  revive the ops run the hand ``matmul`` and ``flash_attention`` kernels on
  the card (``guard.probe``); the engine's steps themselves are plain
  torch, so the shadow checks compare torch with torch.

Both runs emit the full cluster row set — TTFT, latency, throughput, plus
the robustness rows (``*_goodput``, ``*_availability``, ``*_faults``) whose
clean-vs-faulted delta is the headline.  The suite *asserts* the chaos
contract before reporting: zero lost sessions, and token-exact output for
every non-deadline session against the clean run.  Fault injection is
host-side flag flipping (no sleeps, no wall-clock coupling), so the faulted
rows are as reproducible as the clean ones.  On a CPU device
``serving_chaos[cuda]`` gives one ``serving_chaos_skipped`` row.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.registry import register
from repro_torch.core.timing import resolve_device

from ._skip import skipped_on_cpu
from .serving import _build_model

#: the guarded legs' tolerance ladder on the card (the guard's default,
#: "T4", stays for the host)
CARD_GUARD_HW = "nvidia-h100-sxm"


def _fault_plan():
    """Fixed schedule exercising every fault kind but drift (see module docstring).

    Ticks are injector ticks: the crash lands while prompts are mid-decode,
    the straggler window overlaps the crash outage (the skip-last-replica
    guard keeps the cluster alive), and the NaN/kernel/page faults hit the
    surviving replica once failover has concentrated load on it.
    """
    from repro_torch.serve import Fault, FaultPlan

    return FaultPlan(faults=(
        Fault(tick=2, kind="crash", replica=0, duration=4),
        # explicit factor: with 2 replicas the fleet median sits between the
        # healthy and dilated step times, so the throttle-signature default
        # (~1.35x) lands below its own threshold — 4x detects unambiguously
        Fault(tick=3, kind="straggler", replica=1, duration=4, factor=4.0),
        Fault(tick=8, kind="kernel_fault", replica=1),
        Fault(tick=10, kind="nan_logits", replica=1, lanes=(0,), duration=1),
        Fault(tick=11, kind="page_pressure", replica=1, pages=2, duration=3),
    ))


def _guard_fault_plan():
    """Op-targeted schedule for the guarded legs: a seeded numeric drift on
    ``matmul`` (caught by the shadow oracle, attributed, quarantined) and a
    simulated kernel fault on ``flash_attention`` (attributed to the op
    instead of triggering a whole-engine degrade).  Both expire mid-run so
    the breaker's cooldown + half-open probe revives the ops before the
    drive ends.
    """
    from repro_torch.serve import Fault, FaultPlan

    return FaultPlan(seed=7, faults=(
        Fault(tick=3, kind="kernel_drift", replica=1, duration=2,
              op="matmul", drift_scale=0.25),
        Fault(tick=7, kind="kernel_fault", replica=1, op="flash_attention"),
    ))


def _drive_chaos(cfg, model, params, *, backend, n_slots, prompt_len, out_len,
                 requests, prefill_chunk, page_size, seed=0, plan=None,
                 guard=None):
    """One measured cluster run over seeded prompts; ``plan`` switches the
    measured batch from a plain ``run()`` to a fault-injected drive, and
    ``guard`` arms the engines' numerics guard (short re-probe cooldown so
    quarantined ops revive within the drive).  ``degrade`` is on, as the
    reference's default is, so an injected step fault that names no op
    degrades the engine once (a real failure on the card still raises).  The warm-up batch also ages
    each replica past the straggler warm-up gate so the measured run's
    detector is armed.  Returns ``(cluster, sessions)``.
    """
    from repro_torch.serve import (
        ClusterConfig,
        ClusterRouter,
        EngineConfig,
        FaultInjector,
        HealthConfig,
    )

    cluster = ClusterRouter(model, params, ClusterConfig(
        engine=EngineConfig(
            n_slots=n_slots,
            max_len=prompt_len + out_len + 1,
            prefill_chunk=prefill_chunk,
            page_size=page_size,
            backend=backend,
            degrade=True,
            guard=guard,
            guard_cooldown=2 if guard else 8,
        ),
        n_replicas=2,
        router="round_robin",  # deterministic placement for the contrast
        # guarded legs shadow-execute every step, which reshapes wall-clock
        # step times; they gate numerics, not timing, so the (inherently
        # wall-clock) straggler detector stays off there for determinism
        health=HealthConfig(heartbeat_timeout=2, min_samples=3,
                            margin=0.25, cooldown=6, warmup_ticks=6,
                            straggler=guard is None),
    ))
    rng = np.random.default_rng(seed)

    def submit_batch(n):
        return [
            cluster.submit(
                [int(t) for t in rng.integers(1, cfg.vocab_size, prompt_len)],
                max_new_tokens=out_len,
            )
            for _ in range(n)
        ]

    warm = submit_batch(min(2, requests))
    cluster.run(max_ticks=50 * max(len(warm), 1) * out_len)
    cluster.reset_metrics()
    sessions = submit_batch(requests)
    if plan is None:
        cluster.run(max_ticks=50 * requests * out_len)
    else:
        FaultInjector(plan, cluster).run(max_ticks=50 * requests * out_len)
    done = sum(s.done for s in sessions)
    if done != requests:
        raise RuntimeError(f"cluster served {done}/{requests} requests")
    return cluster, sessions


@register(
    "serving_chaos",
    backends=("cuda", "torch"),
    paper_ref="§4.5 (same workload, clean vs throttled contrast)",
    description="cluster goodput/availability under a fixed fault schedule vs clean",
    quick={"n_slots": 2, "prompt_len": 8, "out_len": 8, "requests": 6,
           "prefill_chunk": 4, "page_size": 4},
    full={"n_slots": 2, "prompt_len": 8, "out_len": 12, "requests": 10,
          "prefill_chunk": 4, "page_size": 4},
)
def bench_serving_chaos(n_slots=2, prompt_len=8, out_len=8, requests=6,
                        prefill_chunk=4, page_size=4, seed=0,
                        backend="torch", device="cuda") -> list:
    """Clean and faulted runs over the same seeded workload; the faulted
    run must lose nothing and stay token-exact (non-deadline sessions)
    before its rows are reported.  On the ``cuda`` backend two guarded
    legs additionally prove the numerics guard's contract (zero drift on
    clean, 100% detection + op-scoped quarantine on injected drift)."""
    guarded = backend != "torch" and requests * out_len >= 32
    skipped = skipped_on_cpu("serving_chaos", 2 + 2 * guarded, backend, device)
    if skipped:
        return skipped
    dev = resolve_device(device)
    cfg, model, params = _build_model(dev)
    common = dict(backend=backend, n_slots=n_slots, prompt_len=prompt_len,
                  out_len=out_len, requests=requests,
                  prefill_chunk=prefill_chunk, page_size=page_size, seed=seed)
    clean, clean_sessions = _drive_chaos(cfg, model, params, **common)
    faulted, faulted_sessions = _drive_chaos(
        cfg, model, params, plan=_fault_plan(), **common
    )
    # the chaos contract gates reporting: same prompts, same tokens
    for ref, s in zip(clean_sessions, faulted_sessions):
        if s.finish_reason == "deadline":
            continue
        if s.out != ref.out:
            raise RuntimeError(
                f"chaos run diverged from clean run on rid {s.rid}: "
                f"{s.out} != {ref.out}"
            )
    recs = []
    recs.extend(clean.to_records(
        "serving_chaos", "serving_chaos_clean", x="clean"))
    recs.extend(faulted.to_records(
        "serving_chaos", "serving_chaos_faulted", x="faulted"))
    # the guarded legs' fixed inject->detect->quarantine->heal schedule
    # needs enough measured ticks to play out; trimmed smoke workloads skip
    # them — tests/test_torch_faults.py covers the same contract on the CPU
    if guarded:
        hw = CARD_GUARD_HW if dev.type == "cuda" else "T4"
        recs.extend(_guarded_legs(cfg, model, params, clean_sessions, common, hw))
    return recs


def _guarded_legs(cfg, model, params, clean_sessions, common, hw="T4") -> list:
    """Run the guarded-clean and guarded-faulted legs and assert the guard
    contract (see module docstring).  Each leg isolates the process-global
    guard state so intentional injections cannot leak into other suites or
    the runner's clean-run drift gate.  ``hw`` names the part whose
    tolerance ladder the guard applies.
    """
    from repro_torch.kernels import guard as kguard

    with kguard.isolated(kguard.GuardConfig(hw=hw)):
        gclean, gclean_sessions = _drive_chaos(
            cfg, model, params, guard="shadow", **common)
        gclean_sum = gclean.summary()
    for ref, s in zip(clean_sessions, gclean_sessions):
        if s.out != ref.out:
            raise RuntimeError(
                f"guarded clean run diverged from clean run on rid {s.rid}: "
                f"{s.out} != {ref.out}"
            )
    if gclean_sum["guard_checks"] == 0:
        raise RuntimeError("guarded clean run performed no shadow checks")
    if gclean_sum["drift_events"] or gclean_sum["op_degradations"]:
        raise RuntimeError(
            "numerics guard flagged a clean run: "
            f"{gclean_sum['drift_events']} drift event(s), "
            f"{gclean_sum['op_degradations']} op degradation(s)"
        )

    with kguard.isolated(kguard.GuardConfig(hw=hw)):
        guarded, guarded_sessions = _drive_chaos(
            cfg, model, params, plan=_guard_fault_plan(), guard="shadow",
            **common)
        gsum = guarded.summary()
        gmetrics = kguard.metrics()
        injected = sum(
            r.engine._injected_drift_calls for r in guarded.replicas
        )
    for ref, s in zip(clean_sessions, guarded_sessions):
        if s.finish_reason == "deadline":
            continue
        if s.out != ref.out:
            raise RuntimeError(
                f"guarded faulted run diverged from clean run on rid "
                f"{s.rid}: {s.out} != {ref.out}"
            )
    if injected < 1:
        raise RuntimeError("guard fault plan injected no drift calls")
    if gsum["drift_events"] != injected:
        raise RuntimeError(
            f"guard detected {gsum['drift_events']} of {injected} "
            "injected drift call(s)"
        )
    if gmetrics.quarantined_ops != {"matmul", "flash_attention"}:
        raise RuntimeError(
            "guard quarantined "
            f"{sorted(gmetrics.quarantined_ops)}, expected exactly "
            "['flash_attention', 'matmul']"
        )
    if gsum["degradations"]:
        raise RuntimeError(
            "guarded run fell back to whole-engine degradation "
            f"({gsum['degradations']}x) instead of per-op quarantine"
        )
    if gsum["op_revivals"] < 1:
        raise RuntimeError(
            "breaker never revived a quarantined op within the drive"
        )
    recs = list(guarded.to_records(
        "serving_chaos", "serving_chaos_guarded", x="guarded"))
    recs.extend(gmetrics.to_records(
        "serving_chaos", "serving_chaos_guard", x="guarded"))
    return recs
