"""What the drivers share: the model on the card with the benchmark's
weights, the traced span's schedule, and the comparison's small helpers."""
from __future__ import annotations

import time

from perfbench import weights


def build(ctx):
    """(model, cfg, weight layout, params): the program's model for the cell
    with weights made from the seed."""
    from repro_torch.models import build_model

    cfg = ctx.port_config()
    model = build_model(cfg, device=ctx.device)
    ctx.mark("program imported")
    spec = weights.layout(build_model(cfg, device="cpu").init)
    params = weights.build(spec, ctx.seed, ctx.device)
    sync(ctx)
    ctx.mark("weights made")
    return model, cfg, spec, params


def sync(ctx) -> None:
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize(ctx.device)


class TraceSchedule:
    """Starts the tracer at the first step boundary past ``start`` of the
    window (a share of it) and stops it at the first past ``span_s`` more
    (or the window's end)."""

    def __init__(self, ctx, start: float = 0.3, span_s: float = 6.0):
        self.ctx = ctx
        self.at = ctx.t_window + start * ctx.seconds
        self.until = self.at + min(span_s, (1 - start) * ctx.seconds)

    def tick(self) -> None:
        tracer = self.ctx.tracer
        now = time.perf_counter()
        if not tracer.active and not tracer.done and now >= self.at:
            tracer.start()
        elif tracer.active and now >= self.until:
            tracer.stop()

    def close(self) -> None:
        self.ctx.tracer.stop()


def free(ctx) -> None:
    """Return the program's freed memory to the card before a reference."""
    import gc

    gc.collect()
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def worst_relative_gap(prog: dict, ref: dict) -> tuple:
    """max over the keys of |prog - ref| / max(ref, median ref): the gap
    between two readings of a norm, against the reference's norm of that key
    or of the median key, whichever is larger.  Returns (gap, key)."""
    import statistics

    med = statistics.median(ref.values())
    worst, where = 0.0, None
    for key, r in ref.items():
        gap = abs(prog[key] - r) / max(r, med, 1e-30)
        if gap > worst:
            worst, where = gap, key
    return worst, where
