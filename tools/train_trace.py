"""Trace one gemma-2b train step at full width and depth on the card.

    python tools/train_trace.py [--batch 2] [--seq 1024] [--top 12]

Builds gemma-2b as ``chip_smoke.py`` phase 12(a) trains it (blockwise
attention, remat "full", bf16 compute, fp32 params and AdamW state), takes
two untraced warm-up steps on ``SyntheticLM`` batches, then one step under
``torch.profiler``.  Prints the card's name and power limit, the step's wall
time, the device's busy time (the union of its kernels' intervals) and idle
share, and the device operations with the most time, grouped by name, each
with its share of the busy time and its call count.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))


def busy_us(events) -> float:
    """The union of the device events' [start, end) intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.train.step import TrainState, make_train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_trace: no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cfg = get_config("gemma-2b")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = AdamW()
    state = TrainState(params, opt.init(params))
    step = make_train_step(model.loss_fn, opt, cosine_with_warmup(1e-3, 1, 4))
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0).batch_at,
                        device=dev, prefetch=0)
    for _ in range(2):  # warm-up: cuBLAS handles, the allocator's pools
        state, m = step(state, next(pipe)[1])
        float(m["loss"])
    batch = next(pipe)[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us(device)
    by_name: dict = {}
    for e in device:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    print("train step trace: " + json.dumps({
        "batch": args.batch, "seq": args.seq, "wall_s": wall, "device_busy_s": busy / 1e6,
        "device_idle_share": 1 - busy / 1e6 / wall, "device_ops": len(device),
        "tokens_per_s": args.batch * args.seq / wall}), flush=True)
    for name, (t, n) in top:
        print(f"  {t / 1e3:9.2f} ms  {t / busy:6.1%}  x{n:<5d} {name[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
