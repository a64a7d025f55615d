"""Serving launcher: batched requests through the pluggable serving engine.

Port of ``repro.launch.serve``, with its flags and printed lines.
``--backend`` takes the port's backends (``cuda``, the hand kernels, or
``torch``, the oracle), and ``--device`` picks the card (``cuda``, the
default: with no card visible the launcher exits non-zero) or the host
(``cpu``).  The weights are random, from a generator seeded with ``--seed``
on the model's device.

    python -m repro_torch.launch.serve --arch qwen2.5-14b --reduced \
        --requests 6 --max-new 16 --scheduler priority --backend torch

Paged KV + shared prefix:

    python -m repro_torch.launch.serve --arch gemma-2b --reduced \
        --requests 8 --slots 6 --page-size 16 --n-pages 48 --shared-prefix 12

Cluster scale-out — data-parallel replicas behind one router (on one card
they share the model's params and step one after another; tensor-parallel
replicas, ``--tp > 1``, need a process group per replica under one router,
ROADMAP.md §1 item 11b, and exit with its message):

    python -m repro_torch.launch.serve --arch gemma-2b --reduced \
        --requests 12 --replicas 2 --router least_loaded

Chaos drill — seeded fault schedule against a health-monitored cluster;
deadlines bound per-request latency:

    python -m repro_torch.launch.serve --arch gemma-2b --reduced \
        --requests 12 --replicas 2 --health --chaos --chaos-seed 7 \
        --deadline-s 30

Add ``--device cpu`` to any of these to run on the host.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.timing import NoCudaDeviceError, resolve_device
from repro_torch.kernels.api import BACKENDS
from repro_torch.models import build_model
from repro_torch.serve import (
    SCHEDULERS,
    ClusterConfig,
    ClusterRouter,
    EngineConfig,
    FaultInjector,
    FaultPlan,
    HealthConfig,
    ServeEngine,
    UnsupportedFamilyError,
    make_router,
    replica_meshes,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero with no card visible) or cpu")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--scheduler", choices=sorted(SCHEDULERS), default="fcfs")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="kernel_policy backend for the engine's steps "
                         "(default: the device's own, cuda on the card)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV slots per page; enables the paged KV pool "
                         "(default: dense per-slot regions)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="page-pool size (default: worst case, "
                         "slots * ceil(max_len/page_size)); set lower to "
                         "oversubscribe slots against real KV memory")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="length of a common prefix prepended to every "
                         "prompt and registered once via register_prefix "
                         "(paged mode only)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind one router "
                         "(>1 selects the ClusterRouter path)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree per replica (>1 selects the "
                         "ClusterRouter path; only 1 runs in the port so far)")
    ap.add_argument("--router", default="least_loaded",
                    help="replica placement policy (cluster path only): any "
                         "built-in or register_router()-registered name")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline in seconds; expired requests "
                         "finish with finish_reason='deadline'")
    ap.add_argument("--health", action="store_true",
                    help="enable health monitoring on the cluster path "
                         "(heartbeat + straggler failover, circuit breaker)")
    ap.add_argument("--chaos", action="store_true",
                    help="drive the run through a FaultInjector with a "
                         "seeded random fault schedule")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for FaultPlan.random (with --chaos)")
    ap.add_argument("--chaos-faults", type=int, default=4,
                    help="number of scheduled faults (with --chaos)")
    args = ap.parse_args(argv)
    try:  # fail fast on a bad router name; the error lists registered names
        make_router(args.router)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.shared_prefix and args.page_size is None:
        raise SystemExit("--shared-prefix requires --page-size (paged KV)")
    try:
        dev = resolve_device(args.device)
    except NoCudaDeviceError as e:
        raise SystemExit(str(e)) from None

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    clustered = args.replicas > 1 or args.tp > 1
    if args.tp > cfg.max_useful_tp():
        print(
            f"note: --tp {args.tp} exceeds {args.arch}'s max useful TP "
            f"{cfg.max_useful_tp()} (n_heads={cfg.n_heads}, "
            f"n_kv_heads={cfg.n_kv_heads}); extra devices stay replicated"
        )
    if clustered:  # the cluster's placement errors, before the weights are made
        try:
            replica_meshes(args.replicas, args.tp, [dev] if dev.type == "cpu" else None)
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(str(e)) from None

    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    engine_cfg = EngineConfig(
        n_slots=args.slots,
        max_len=args.max_len,
        prefill_chunk=args.prefill_chunk,
        page_size=args.page_size,
        n_pages=args.n_pages,
        backend=args.backend,
        scheduler=args.scheduler,
        # a chaos drill injects step faults that name no kernel op: the engine
        # degrades once to the torch backend (only an injected failure may)
        degrade=args.chaos,
    )
    try:
        if clustered:
            engine = ClusterRouter(model, params, ClusterConfig(
                engine=engine_cfg, n_replicas=args.replicas, tp=args.tp,
                router=args.router,
                health=HealthConfig() if args.health else None))
        else:
            engine = ServeEngine(model, params, engine_cfg)
    except UnsupportedFamilyError as e:
        raise SystemExit(str(e)) from None

    rng = np.random.default_rng(args.seed)
    prefix = []
    try:
        if args.shared_prefix:
            prefix = [int(t) for t in rng.integers(1, cfg.vocab_size, args.shared_prefix)]
            engine.register_prefix(prefix)
        sessions = [
            engine.submit(
                prefix + list(rng.integers(1, cfg.vocab_size, args.prompt_len)),
                args.max_new,
                priority=i % 3,  # exercise the priority axis under --scheduler priority
                deadline_s=args.deadline_s,
            )
            for i in range(args.requests)
        ]
    except UnsupportedFamilyError as e:  # cluster replicas build lazily here
        raise SystemExit(str(e)) from None
    injector = None
    if args.chaos:
        plan = FaultPlan.random(
            args.chaos_seed, n_faults=args.chaos_faults,
            n_replicas=args.replicas if clustered else 1)
        injector = FaultInjector(plan, engine)
        finished = injector.run()
    else:
        finished = engine.run()
    s = engine.summary()
    if clustered:
        per = s["per_replica"]
        print(
            f"cluster: {s['replicas']} replica(s) x tp={s['tp']} "
            f"({args.router}); requests per replica: "
            f"{[r['requests'] for r in per]}"
        )
    print(
        f"served {len(finished)}/{len(sessions)} requests, "
        f"{s['generated_tokens']} tokens in {s['total_s']:.2f}s "
        f"({s['throughput_tok_s']:.1f} tok/s, prefill {s['prefill_tok_s']:.1f} tok/s)"
    )
    print(
        f"ttft {s['ttft_ms_mean']:.1f}ms mean / {s['ttft_ms_p95']:.1f}ms p95; "
        f"per-token p50 {s['tok_latency_ms_p50']:.2f}ms p95 "
        f"{s['tok_latency_ms_p95']:.2f}ms; occupancy {s['occupancy']:.0%}"
    )
    if args.page_size is not None:
        n_pages = (sum(r.engine.n_pages for r in engine.replicas) if clustered
                   else engine.n_pages)
        print(
            f"paged KV: {n_pages} pages x {args.page_size} slots, "
            f"peak {s['pages_peak']} used ({s['page_occupancy']:.0%} mean), "
            f"{s['preemptions']} preemptions, "
            f"{s['prefix_tokens_reused']} prefix tokens reused "
            f"({s['prefix_hits']} hits)"
        )
    if injector is not None:
        inj = injector.summary()
        applied = {k: v for k, v in inj["applied"].items() if v}
        print(
            f"chaos: {inj['plan_faults']} scheduled fault(s), "
            f"applied {applied}, {inj['skipped']} skipped, "
            f"{inj['crash_ticks']} crashed tick(s)"
        )
    if injector is not None or args.deadline_s is not None or args.health:
        line = (
            f"robustness: goodput {s['goodput_tok_s']:.1f} tok/s, "
            f"{s['deadline_expired']} deadline-expired, "
            f"{s['requeues']} requeues, {s['quarantines']} quarantines, "
            f"{s['degradations']} degradations"
        )
        if clustered:
            line += (f", availability {s['availability']:.0%}, "
                     f"failovers {s['failovers']}")
        print(line)
    for sess in finished[:4]:
        print(f"  req {sess.rid} [{sess.finish_reason}]: "
              f"{sess.out[:10]}{'...' if len(sess.out) > 10 else ''}")
    return finished


if __name__ == "__main__":
    main()
