"""Closed-loop serving: ``clients`` clients over the program's paged
``ServeEngine``, each sending its next request as soon as its last one
finished.  Greedy decoding; sizes and ids from ``perfbench.traffic``.

Set-up builds the engine with the benchmark's weights, and every client
sends its first request; one engine tick prefills them all and decodes one
step, which builds and warms every shape the window uses.  The window then
runs engine ticks until ``--seconds`` have passed; the clients stop sending
when it closes, and the ticks go on until every request sent in the window
has its first token (or ``drain_limit_s`` passes: it counts as missing).
A request that finished in any other way than with all its tokens, in one
pass of the engine, streamed as the engine recorded them, is bad: the check
allows none, and ``failed`` counts the window's missing and bad requests.

The check takes a sample of finished requests, drawn from the seed with the
longest among them, runs the plain reference once over each prompt with its
served tokens, and reads by how much each served token's logit lies below
the reference's best at its position: the mean gap is compared (the widest
gap swings from seed to seed as much as the control's; see PERF.md).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from perfbench import traffic as gen
from perfbench import yardstick
from perfbench.drivers import common
from perfbench.harness import Outcome


@dataclass
class Sent:
    """One request as its client sees it (the client's own clock)."""

    prompt: list
    max_new: int
    submit: float
    times: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    session: object = None

    def on_token(self, session, token: int) -> None:
        self.times.append(time.perf_counter())
        self.tokens.append(int(token))

    @property
    def first(self):
        return self.times[0] if self.times else None

    @property
    def clean(self) -> bool:
        """Finished with all its tokens, never requeued or preempted, and
        streamed as the engine recorded them."""
        s = self.session
        return (s.finish_reason == "max_new_tokens" and len(self.tokens) == self.max_new
                and s.stats.requeues == 0 and s.stats.preemptions == 0 and self.tokens == s.out)


def setup(ctx) -> dict:
    torch = ctx.torch
    from repro_torch.serve import EngineConfig, ServeEngine

    t = ctx.traffic
    model, cfg, spec, params = common.build(ctx)
    engine = ServeEngine(model, params, EngineConfig(
        n_slots=t["lanes"], max_len=t["max_len"], prefill_chunk=t["prefill_chunk"],
        page_size=t["page_size"], guard="off", degrade=False))
    stream = gen.RequestStream(t, ctx.seed, cfg.vocab_size)
    state = {"engine": engine, "params": params, "cfg": cfg, "stream": stream, "sent": [],
             "clients": [None] * t["clients"]}
    with torch.inference_mode():
        for c in range(t["clients"]):
            _send(state, c)
        engine.step()  # the first wave's prefill and one decode step: every shape
    common.sync(ctx)
    return state


def _send(state: dict, client: int) -> Sent:
    req = next(state["stream"])
    sent = Sent(req.prompt, req.max_new_tokens, time.perf_counter())
    sent.session = state["engine"].submit(req.prompt, req.max_new_tokens, on_token=sent.on_token)
    state["sent"].append(sent)
    state["clients"][client] = sent
    return sent


def window(ctx, state: dict) -> Outcome:
    torch = ctx.torch
    engine, tracer = state["engine"], ctx.tracer
    m = engine.metrics
    first_sent = len(state["sent"])
    w0 = ctx.window_start()
    w1 = w0 + ctx.seconds
    sched = common.TraceSchedule(ctx, span_s=ctx.traffic.get("trace_span_s", 6.0))
    ticks0, prefills0, ptoks0 = len(m.decode_s), len(m.prefill_s), m.prefill_tokens
    with torch.inference_mode():
        while time.perf_counter() < w1:
            sched.tick()
            with tracer.span("engine.step"):
                engine.step()
            for c, sent in enumerate(state["clients"]):
                if sent.session.done and time.perf_counter() < w1:
                    with tracer.span("client.submit"):
                        _send(state, c)
        sched.close()
        ticks1, prefills1, ptoks1 = len(m.decode_s), len(m.prefill_s), m.prefill_tokens
        in_window = state["sent"][first_sent:]
        deadline = time.perf_counter() + ctx.traffic["drain_limit_s"]
        while (any(s.first is None and not s.session.done for s in in_window)
               and time.perf_counter() < deadline):
            engine.step()
    common.sync(ctx)

    waited = time.perf_counter()
    emitted = sum(1 for s in state["sent"] for tt in s.times if w0 <= tt < w1)
    ttfts = [s.first - s.submit for s in in_window if s.first is not None]
    missing = sum(1 for s in in_window if s.first is None)
    # a request that never had its first token counts as at least the wait
    # it was given, longer than any that had one
    ttfts += [waited - s.submit for s in in_window if s.first is None]
    state["missing_requests"] = missing
    state["bad_requests"] = sum(1 for s in state["sent"] if s.session.done and not s.clean)
    records = {
        "window": (w0, w1),
        "requests": [{"submit": s.submit, "times": list(s.times), "prompt_len": len(s.prompt),
                      "in_window": i >= first_sent}
                     for i, s in enumerate(state["sent"])],
        "ticks": {"decode_s": m.decode_s[ticks0:ticks1], "occupancy": m.occupancy[ticks0:ticks1]},
        "prefill": {"seconds": m.prefill_s[prefills0:prefills1], "tokens": ptoks1 - ptoks0},
    }
    end_to_end = {"serve_tok_s": yardstick.rate(emitted, ctx.seconds),
                  "ttft_p95_ms": 1e3 * yardstick.p95(ttfts)}
    failed = missing + sum(1 for s in in_window if s.session.done and not s.clean)
    return Outcome(len(in_window), failed, end_to_end, records, answers=state["sent"])


def sample(ctx, sent: list) -> list:
    """Finished requests for the check: the one with the most served
    tokens, then others in an order drawn from the seed, until
    ``sample_min_tokens`` served tokens or ``sample_max_requests``."""
    t = ctx.traffic
    done = [s for s in sent if s.session.done and s.clean]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (len(done[i].tokens), len(done[i].prompt)))
    order = [longest] + [int(i) for i in gen.rng(ctx.seed, 4).permutation(len(done))
                         if i != longest]
    picked, served = [], 0
    for i in order:
        if served >= t["sample_min_tokens"] or len(picked) >= t["sample_max_requests"]:
            break
        picked.append(done[i])
        served += len(done[i].tokens)
    return picked


def groups_of(ctx, n_prompt: int, n_total: int) -> tuple:
    """Each position's routing group and each group's slots per expert, as
    the engine's steps route them: the prompt in chunks of
    ``prefill_chunk`` (one group a chunk, its capacity from the chunk's
    length), then every decoded token a group of its own."""
    torch = ctx.torch
    from perfbench.reference.common import moe_capacity

    m, chunk = ctx.model, ctx.traffic["prefill_chunk"]
    n_chunks = -(-n_prompt // chunk)
    groups = [p // chunk for p in range(n_prompt)] + list(
        range(n_chunks, n_chunks + n_total - n_prompt))
    cap = [moe_capacity(chunk, m["experts_per_token"], m["capacity_factor"], m["n_experts"])
           ] * n_chunks + [moe_capacity(1, m["experts_per_token"], m["capacity_factor"],
                                        m["n_experts"])] * (n_total - n_prompt)
    return (torch.tensor(groups, device=ctx.device), torch.tensor(cap, device=ctx.device))


def _gaps(best, logits, tokens):
    """How far each token's reference logit lies below the reference's best
    at its position."""
    return best - logits.gather(-1, tokens[:, None])[:, 0]


def _summary(gaps, prefix: str = "") -> dict:
    """The widest gap, the mean gap and the share of tokens that are not the
    reference's first choice, over every compared token."""
    return {f"{prefix}logit_gap": float(gaps.max()), f"{prefix}logit_gap_mean": float(gaps.mean()),
            f"{prefix}not_first_share": float((gaps > 0).float().mean())}


def readings(ctx, state: dict, outcome: Outcome, control: bool = False) -> dict:
    """Over the sample's served tokens: the widest and the mean gap by which
    a served token's logit lies below the float32 reference's best, and the
    share not first; with ``control``, the same of the token the float8
    reference puts first at each position ("control." names)."""
    torch = ctx.torch
    from perfbench.reference import moe_lm
    from perfbench.reference.common import Numerics, fp32_matmuls

    picked = sample(ctx, outcome.answers)
    state["engine"] = None
    state["clients"] = None
    common.free(ctx)
    if not picked:
        return {"logit_gap": float("inf"), "logit_gap_mean": float("inf"),
                "not_first_share": float("inf")}
    served, low = [], []
    with torch.no_grad(), fp32_matmuls():
        for s in picked:
            seq = s.prompt + s.tokens[:-1]
            groups, caps = groups_of(ctx, len(s.prompt), len(seq))
            tokens = torch.tensor([seq], device=ctx.device)
            logits = moe_lm.forward(Numerics(), state["params"], tokens, ctx.model, groups,
                                    caps)[0][0, len(s.prompt) - 1:]
            best = logits.max(dim=-1).values
            served.append(_gaps(best, logits, torch.tensor(s.tokens, device=ctx.device)))
            if control:
                ctl = moe_lm.forward(Numerics(quant=True), state["params"], tokens, ctx.model,
                                     groups, caps)[0][0, len(s.prompt) - 1:]
                low.append(_gaps(best, logits, ctl.argmax(dim=-1)))
    out = {**_summary(torch.cat(served)), "served_tokens_checked": sum(map(len, served))}
    if control:
        out.update(_summary(torch.cat(low), "control."))
    return out


def check(ctx, state: dict, outcome: Outcome, r: dict) -> list:
    """The mean logit gap of the readings ``r`` (the widest is printed
    beside it); the window's requests that never had a first token, and the
    finished requests that are bad (none of either may be)."""
    return [("logit_gap_mean", r["logit_gap_mean"], ctx.cell.limits["logit_gap_mean"]),
            ("missing_requests", float(state["missing_requests"]), 0.0),
            ("bad_requests", float(state["bad_requests"]), 0.0)]
