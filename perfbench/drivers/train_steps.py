"""Training steps: the program's ``make_train_step`` (AdamW, the cosine
schedule, clipping) fed by its ``DataPipeline`` with prefetch, on batches
from the benchmark's synthetic stream, each step ending in reading its loss.

Set-up builds the one training object (model, state, step, pipeline) with
the benchmark's weights and drives it through its first ``check_steps``
steps; they are the warm-up and what the check reads: each step's loss,
every leaf's first gradient as the optimizer got it (its first moment after
one step over 1 - b1) and every leaf's change after the last of them.  The
window goes on with the same object.  The check follows those steps with
the plain float32 reference and reads the worst gap of each number.  A
"leaf" here is one layer's slice of a stacked parameter.
"""
from __future__ import annotations

import time

from perfbench import traffic as gen
from perfbench import weights, yardstick
from perfbench.drivers import common
from perfbench.harness import Outcome


def leaf_slices(spec: list, tree_get) -> dict:
    """{name: tensor} over the weights, a stacked leaf cut into its layers."""
    out = {}
    for path, shape, _ in spec:
        t = tree_get(path)
        name = ".".join(path)
        if path[0] == "layers":
            for i in range(shape[0]):
                out[f"{name}[{i}]"] = t[i]
        else:
            out[name] = t
    return out


def _norms(slices: dict) -> dict:
    return {k: float(v.float().norm()) for k, v in slices.items()}


def setup(ctx) -> dict:
    torch = ctx.torch
    from repro_torch.data import DataPipeline
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.train.step import TrainState, make_train_step

    t = ctx.traffic
    o = t["optimizer"]
    model, cfg, spec, params = common.build(ctx)
    opt = AdamW(b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"])
    step = make_train_step(model.loss_fn, opt,
                           cosine_with_warmup(o["lr"], o["warmup"], o["total"], o["min_frac"]),
                           microbatches=t["microbatches"], clip_norm=o["clip"])
    pipe = DataPipeline(lambda i: gen.train_batch(t, ctx.seed, i, cfg.vocab_size),
                        device=ctx.device, prefetch=t["prefetch"])
    state = {"train": TrainState(params, opt.init(params)), "step": step, "pipe": pipe,
             "spec": spec, "losses": [], "cfg": cfg}
    for i in range(t["check_steps"]):
        _, batch = next(pipe)
        state["train"], metrics = step(state["train"], batch)
        state["losses"].append(float(metrics["loss"]))
        ctx.mark(f"step {i + 1} done")
        if i == 0:  # the first moment after one step is (1 - b1) times the clipped gradient
            mu = state["train"].opt.mu
            state["grad1"] = {k: v / (1 - o["b1"]) for k, v in
                              _norms(leaf_slices(spec, lambda p: weights.get(mu, p))).items()}
    p_now = state["train"].params
    change = {}
    for index, (path, shape, dtype) in enumerate(spec):
        p0 = weights.make_leaf(ctx.seed, index, path, shape, dtype, ctx.device)
        diff = weights.get(p_now, path) - p0
        change.update(_norms(leaf_slices([(path, shape, dtype)], lambda _p: diff)))
        del p0, diff
    state["change"] = change
    common.sync(ctx)
    return state


def window(ctx, state: dict) -> Outcome:
    torch = ctx.torch
    t = ctx.traffic
    tracer = ctx.tracer
    w0 = ctx.window_start()
    sched = common.TraceSchedule(ctx, span_s=t.get("trace_span_s", 6.0))
    steps, end, times = 0, w0, []
    while time.perf_counter() < w0 + ctx.seconds:
        sched.tick()
        t0 = time.perf_counter()
        with tracer.span("pipeline.next"):
            _, batch = next(state["pipe"])
        with tracer.span("step_fn"):
            state["train"], metrics = state["step"](state["train"], batch)
            float(metrics["loss"])
        end = time.perf_counter()
        times.append(end - t0)
        steps += 1
    sched.close()
    tokens = steps * t["batch"] * t["seq"]
    peak = (torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0)
    records = {"steps": steps, "step_s": times, "batch": t["batch"], "seq": t["seq"],
               "train_peak_bytes": peak, "window_s": end - w0}
    return Outcome(steps, 0, {"train_tok_s": yardstick.rate(tokens, end - w0)}, records)


def reference_readings(ctx, state: dict, quant: bool) -> dict:
    """The float32 (or, ``quant``, float8) reference's losses, first
    gradients and changes over the check's steps, from weights made again
    from the seed."""
    torch = ctx.torch
    from perfbench.reference import train as ref_train
    from perfbench.reference.common import Numerics, fp32_matmuls

    t = ctx.traffic
    spec = state["spec"]
    params = weights.build([(p, s, torch.float32) for p, s, _ in spec], ctx.seed, ctx.device)
    vocab = ctx.model["vocab_size"]
    batches = [{k: torch.from_numpy(v).to(ctx.device)
                for k, v in gen.train_batch(t, ctx.seed, i, vocab).items()}
               for i in range(t["check_steps"])]
    out = {"losses": []}
    order = [p for p, _, _ in spec]

    def on_step(i, loss, grads):
        out["losses"].append(loss)
        if i == 0:
            by_path = dict(zip(order, grads))
            out["grad1"] = _norms(leaf_slices(spec, lambda p: by_path[p]))

    with fp32_matmuls():
        ref_train.run(Numerics(quant=quant), params, batches, ctx.model, t["optimizer"], on_step)
    change = {}
    for index, (path, shape, _) in enumerate(spec):
        p0 = weights.make_leaf(ctx.seed, index, path, shape, torch.float32, ctx.device)
        diff = weights.get(params, path) - p0
        change.update(_norms(leaf_slices([(path, shape, None)], lambda _p: diff)))
    out["change"] = change
    return out


def compare(prog: dict, ref: dict, nought_share: float) -> dict:
    """The three numbers: the worst relative loss gap over the steps, the
    worst leaf's first-gradient gap and the worst leaf's change gap (leaves
    whose reference gradient is under ``nought_share`` of the median leaf's
    left out of the change)."""
    import statistics

    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad, _ = common.worst_relative_gap(prog["grad1"], ref["grad1"])
    med = statistics.median(ref["grad1"].values())
    moved = [k for k, g in ref["grad1"].items() if g >= nought_share * med]
    change, _ = common.worst_relative_gap({k: prog["change"][k] for k in moved},
                                          {k: ref["change"][k] for k in moved})
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "leaves": len(ref["grad1"]), "leaves_left_out": len(ref["grad1"]) - len(moved)}


def readings(ctx, state: dict, outcome: Outcome, control: bool = False) -> dict:
    prog = {"losses": state["losses"], "grad1": state["grad1"], "change": state["change"]}
    state["pipe"].close()
    state["train"] = state["step"] = state["pipe"] = None
    common.free(ctx)
    share = ctx.traffic["nought_grad_share"]
    ref = reference_readings(ctx, state, quant=False)
    out = compare(prog, ref, share)
    if control:
        common.free(ctx)
        low = reference_readings(ctx, state, quant=True)
        out.update({f"control.{k}": v for k, v in compare(low, ref, share).items()})
    return out


def check(ctx, state: dict, outcome: Outcome, r: dict) -> list:
    return [(k, r[k], ctx.cell.limits[k]) for k in ("loss_gap", "grad_gap", "change_gap")]
