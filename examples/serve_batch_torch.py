"""Batched serving example on the PyTorch port: continuous batching over
more requests than slots on a reduced gemma config, with a streamed
(per-token callback) request, a priority scheduler, paged KV with a shared
system prefix, and the engine's serving metrics.  It runs on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_batch_torch.py
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

Scale the same workload out with data-parallel replicas; the
prefix-affinity router keeps prompts that share the system prefix on the
replica that holds its pages, and a mid-run replica failure drains and
resumes its sessions on the survivor:

    PYTHONPATH=src python examples/serve_batch_torch.py --replicas 2 --fail-one

Tensor-parallel replicas (the JAX example's ``--tp``) wait for the port's
distribution layer.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.timing import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import (
    ROUTERS,
    ClusterConfig,
    ClusterRouter,
    EngineConfig,
    PriorityScheduler,
    ServeEngine,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1 serves through a ClusterRouter instead of one engine")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails with no card visible) or cpu")
    ap.add_argument("--router", choices=sorted(ROUTERS), default="prefix_affinity")
    ap.add_argument("--fail-one", action="store_true",
                    help="kill replica 0 mid-run to demo drain/requeue "
                         "(requires --replicas >= 2)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config("gemma-2b").reduced()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    # paged KV: lanes draw 16-token pages from a shared pool instead of
    # reserving max_len each; drop page_size for the dense layout
    engine_cfg = EngineConfig(n_slots=4, max_len=96, prefill_chunk=8, page_size=16)
    clustered = args.replicas > 1
    if clustered:
        engine = ClusterRouter(model, params, ClusterConfig(
            engine=engine_cfg, n_replicas=args.replicas, router=args.router))
    else:
        engine = ServeEngine(model, params, engine_cfg,
                             scheduler=PriorityScheduler())

    rng = np.random.default_rng(0)
    # a "system prompt" stored once: every request below starts with it and
    # shares its KV pages copy-on-write instead of re-prefilling them (on a
    # cluster, the prefix lives on one replica and the prefix_affinity
    # router sends matching prompts there)
    system = list(rng.integers(1, cfg.vocab_size, 12))
    engine.register_prefix(system)
    for i in range(10):
        prompt = system + list(rng.integers(1, cfg.vocab_size, 4 + i % 5))
        engine.submit(prompt, max_new_tokens=8 + i % 7, priority=i % 3)

    # a streamed request: tokens arrive through the callback as they decode
    streamed = []
    engine.submit(
        list(rng.integers(1, cfg.vocab_size, 6)),
        max_new_tokens=10,
        priority=5,  # jumps the queue under PriorityScheduler (no shared prefix)
        on_token=lambda sess, tok: streamed.append(tok),
    )

    if args.fail_one:
        if args.replicas < 2:
            raise SystemExit("--fail-one requires --replicas >= 2")
        for _ in range(3):  # let some sessions get mid-decode first
            engine.step()
        requeued = engine.fail_replica(0)
        print(f"failed replica 0: {len(requeued)} session(s) requeued "
              f"with output intact")

    finished = engine.run()
    s = engine.summary()
    if clustered:
        print(f"cluster: {s['replicas']} replica(s) x tp={s['tp']} "
              f"({args.router}), {s['failures']} failure(s)")
    print(
        f"served {len(finished)} requests / {s['generated_tokens']} tokens "
        f"in {s['total_s']:.2f}s ({s['throughput_tok_s']:.1f} tok/s, "
        f"ttft {s['ttft_ms_mean']:.0f}ms, occupancy {s['occupancy']:.0%})"
    )
    print(f"streamed request got {len(streamed)} tokens via callback: {streamed}")
    n_pages = (sum(r.engine.n_pages for r in engine.replicas) if clustered
               else engine.n_pages)
    print(
        f"paged KV: peak {s['pages_peak']}/{n_pages} pages, "
        f"{s['prefix_tokens_reused']} system-prompt tokens reused across "
        f"{s['prefix_hits']} requests"
    )
    for sess in sorted(finished, key=lambda x: x.rid):
        print(
            f"  req {sess.rid} prio {sess.priority} [{sess.finish_reason}]: "
            f"prompt[{len(sess.prompt)}] -> {sess.out}"
        )


if __name__ == "__main__":
    main()
