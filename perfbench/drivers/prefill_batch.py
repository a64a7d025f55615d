"""Back-to-back prefill calls: ``model.prefill`` on ``batch`` prompts of
``seq`` fresh ids a call (from the seed), each call read to the host as a
user would (the next tokens), until ``--seconds`` have passed.

Set-up makes the weights and runs one call, which builds and warms every
shape.  The check compares one call of the window, drawn from the seed,
with the plain reference: the last logits and the whole cache it left
(each shared-attention call's k and v, each Mamba2 layer's final SSM state
and conv inputs), each as the relative L2 distance, the worst over layers.
"""
from __future__ import annotations

import time

from perfbench import traffic as gen
from perfbench import yardstick
from perfbench.drivers import common
from perfbench.harness import Outcome

PARTS = ("logits", "k", "v", "ssm", "conv")


def _tokens(ctx, cfg, call: int):
    t = ctx.traffic
    ids = ctx.torch.from_numpy(gen.prompt_batch(t, ctx.seed, call, cfg.vocab_size))
    return ids.pin_memory().to(ctx.device, non_blocking=True) if ctx.device.type == "cuda" \
        else ids


def _call(ctx, state: dict, call: int):
    tokens = _tokens(ctx, state["cfg"], call)
    logits, cache = state["model"].prefill(state["params"], {"tokens": tokens},
                                           max_len=ctx.traffic["max_len"])
    logits.argmax(dim=-1).cpu()  # the caller reads the next tokens: the call is done
    return tokens, logits, cache


def setup(ctx) -> dict:
    torch = ctx.torch
    model, cfg, spec, params = common.build(ctx)
    state = {"model": model, "cfg": cfg, "params": params}
    with torch.inference_mode():
        _call(ctx, state, 0)
    common.sync(ctx)
    return state


def window(ctx, state: dict) -> Outcome:
    torch = ctx.torch
    tracer = ctx.tracer
    t = ctx.traffic
    keep = 1 + int(gen.rng(ctx.seed, 5).integers(0, 2))  # the call the check reads
    w0 = ctx.window_start()
    sched = common.TraceSchedule(ctx, span_s=t.get("trace_span_s", 6.0))
    calls, end, kept, times = 0, w0, None, []
    with torch.inference_mode():
        while time.perf_counter() < w0 + ctx.seconds:
            sched.tick()
            with tracer.span("model.prefill"):
                t0 = time.perf_counter()
                answer = _call(ctx, state, calls + 1)
                end = time.perf_counter()
            times.append(end - t0)
            calls += 1
            if calls == keep:
                kept = answer
            del answer
        sched.close()
    tokens = calls * t["batch"] * t["seq"]
    records = {"calls": calls, "call_s": times, "batch": t["batch"], "seq": t["seq"],
               "window_s": end - w0}
    return Outcome(calls, 0, {"prompt_tok_s": yardstick.rate(tokens, end - w0)}, records,
                   answers={"index": keep, "answer": kept})


def _gap(prog, ref) -> float:
    prog, ref = prog.float(), ref.float()
    return float((prog - ref).norm() / ref.norm().clamp_min(1e-30))


def readings(ctx, state: dict, outcome: Outcome, control: bool = False) -> dict:
    """The relative L2 distance of each part of the kept call's answer from
    the reference's, the worst over layers; with ``control``, also each
    part's distance of the float8 reference from the float32 one."""
    torch = ctx.torch
    from perfbench.reference import zamba2
    from perfbench.reference.common import Numerics, fp32_matmuls

    answer = outcome.answers["answer"]
    state["model"] = None
    common.free(ctx)
    if answer is None:
        return {f"{p}_gap": float("inf") for p in PARTS}
    tokens, logits, cache = answer
    s = tokens.shape[1]
    worst = dict.fromkeys(PARTS, 0.0)
    kept_ref: dict = {}

    def visit_program(kind, i, a, b):
        if kind == "kv":
            worst["k"] = max(worst["k"], _gap(cache["k"][i, :, :s], a))
            worst["v"] = max(worst["v"], _gap(cache["v"][i, :, :s], b))
        else:
            worst["ssm"] = max(worst["ssm"], _gap(cache["ssm"][i], a))
            worst["conv"] = max(worst["conv"], _gap(cache["conv"][i], b))
        if control:
            kept_ref[(kind, i)] = (a, b)

    with torch.no_grad(), fp32_matmuls():
        ref_logits = zamba2.prefill(Numerics(), state["params"], tokens, ctx.model,
                                    visit_program)
        worst["logits"] = _gap(logits, ref_logits)
        out = {f"{p}_gap": v for p, v in worst.items()}
        if control:
            low = dict.fromkeys(PARTS, 0.0)

            def visit_control(kind, i, a, b):
                ra, rb = kept_ref.pop((kind, i))
                if kind == "kv":
                    low["k"] = max(low["k"], _gap(a, ra))
                    low["v"] = max(low["v"], _gap(b, rb))
                else:
                    low["ssm"] = max(low["ssm"], _gap(a, ra))
                    low["conv"] = max(low["conv"], _gap(b, rb))

            low_logits = zamba2.prefill(Numerics(quant=True), state["params"], tokens,
                                        ctx.model, visit_control)
            low["logits"] = _gap(low_logits, ref_logits)
            out.update({f"control.{k}_gap": v for k, v in low.items()})
    return out


def check(ctx, state: dict, outcome: Outcome, r: dict) -> list:
    return [(k, r[k], ctx.cell.limits[k]) for k in (f"{p}_gap" for p in PARTS)]
