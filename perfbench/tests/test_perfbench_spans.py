"""The readers of the program's spans and counters on synthetic records: the
program's store stands in for ``repro_torch.core.timing.trace_store``'s,
the trace for the harness's traced span."""
import random

import pytest

from perfbench import harness, program_spans
from perfbench.tests import tiny

IDLE = ("idle.serve.enqueue", "idle.serve.bookkeeping")
READERS = IDLE + ("engine.prefill_useful_pct", "engine.kv_live_pct", "prefill.scan_pct",
                  "train.moe_dispatch_pct", "train.optimizer_pct")


def _read(name, records):
    return harness.read_metric(tiny.ROOT, name, records)


def _span(name, tag, a, b, device_s=None):
    return {"name": name, "id": 0, "parent": None, "thread": 1, "start_s": a, "end_s": b,
            "tag": tag, "device_s": device_s}


@pytest.fixture
def program(monkeypatch):
    """Sets the program's store the readers see."""
    found = {}
    monkeypatch.setattr(program_spans, "store", lambda: found.get("store"))

    def put(spans=(), counters=None):
        found["store"] = {"spans": sorted(spans, key=lambda s: s["start_s"]),
                          "counters": counters or {}}

    return put


def _serve_records(steps, events, window_s):
    busy = sum(b - a for a, b in program_spans.union(events))
    return {"trace": {"window_s": window_s, "busy_s": busy,
                      "device_events": [("k", a, b) for a, b in events],
                      "spans": [("engine.step", a, b) for a, b in steps]}}


#: two ticks by hand (trace seconds; the program's clock starts at 100 and
#: 200): kernels over [0, 1), [3, 4), [6, 10), so the gaps are [1, 3), [4, 6)
HAND_STEPS = [(0.5, 5.0), (5.5, 9.5)]
HAND_EVENTS = [(0.0, 1.0), (3.0, 4.0), (6.0, 10.0)]
HAND_SPANS = [
    _span("engine.tick", 1, 100.0, 104.5), _span("engine.admit", 1, 100.0, 100.5),
    _span("engine.decode.enqueue", 1, 100.5, 103.0),  # at [1.0, 3.5): 2.0 idle
    _span("engine.decode.wait", 1, 103.0, 103.8), _span("engine.emit", 1, 103.8, 104.5),
    _span("engine.tick", 2, 200.0, 201.0), _span("engine.admit", 2, 200.0, 200.1),
    _span("engine.prefill", 2, 200.1, 200.9),
    _span("engine.prefill.enqueue", 2, 200.1, 200.3),  # at [5.6, 5.8): 0.2 idle
    _span("engine.prefill.read", 2, 200.3, 200.9),
    _span("moe.dispatch", 2, 200.15, 200.2, 0.05),  # no engine span: not aligned
]


def test_the_idle_readers_by_hand(program):
    """Enqueue: 2.0 + 0.2 of 10 s.  Bookkeeping: the emit's [4.3, 5.0) and
    the second admission's [5.5, 5.6) lie in gaps, 0.8 of 10 s."""
    program(HAND_SPANS)
    records = _serve_records(HAND_STEPS, HAND_EVENTS, 10.0)
    assert _read("idle.serve.enqueue", records) == pytest.approx(22.0)
    assert _read("idle.serve.bookkeeping", records) == pytest.approx(8.0)
    assert _read("idle.serve", records) == pytest.approx(40.0)


@pytest.mark.parametrize("seed", range(6))
def test_the_idle_readers_never_exceed_the_idle_share(program, seed):
    rng = random.Random(seed)
    steps, spans, t, clock = [], [], 0.0, 50.0
    for tag in range(1, 30):
        t += rng.uniform(0, 0.01)  # the client's work between ticks
        clock += rng.uniform(0, 3)  # the program's clock runs on its own
        parts = [rng.uniform(0.001, 0.02) for _ in range(4)]
        steps.append((t - rng.uniform(0, 1e-4), t + sum(parts)))
        spans.append(_span("engine.tick", tag, clock, clock + sum(parts)))
        at = clock
        for name, d in zip(("engine.admit", rng.choice(program_spans.ENQUEUE),
                            "engine.decode.wait", "engine.emit"), parts):
            spans.append(_span(name, tag, at, at + d))
            at += d
        t += sum(parts)
        clock += sum(parts)
    events, a = [], 0.0
    while a < t:
        d = rng.uniform(0.0005, 0.01)
        events.append((a, min(a + d, t)))
        a += d + rng.choice([0.0, 0.0, rng.uniform(0, 0.005)])
    program(spans)
    records = _serve_records(steps, events, t + 0.01)
    enqueue, bookkeeping = (_read(name, records) for name in IDLE)
    assert enqueue > 0 and bookkeeping > 0
    assert enqueue + bookkeeping <= _read("idle.serve", records) + 1e-9


def test_ticks_that_do_not_pair_with_the_harness_steps_give_none(program):
    program(HAND_SPANS)
    for steps in (HAND_STEPS[:1], HAND_STEPS + [(9.6, 9.9)]):
        records = _serve_records(steps, HAND_EVENTS, 10.0)
        assert all(_read(name, records) is None for name in IDLE)


def test_the_counter_readers_by_hand(program):
    """The engine test's hand-worked tick: 14 tokens fed into 48 slots, 14
    positions live of 128 gathered."""
    program(counters={"engine.prefill_fed": 14, "engine.prefill_slots": 48,
                      "engine.kv_live": 14, "engine.kv_gathered": 128})
    assert _read("engine.prefill_useful_pct", {}) == pytest.approx(100 * 14 / 48)
    assert _read("engine.kv_live_pct", {}) == pytest.approx(100 * 14 / 128)
    program(counters={"engine.prefill_fed": 3})  # no slots: nothing to divide by
    assert _read("engine.prefill_useful_pct", {}) is None


def test_the_device_share_readers_by_hand(program):
    program([_span("train.step", None, 0.0, 3.0),
             _span("train.forward_backward", None, 0.0, 2.0, 1.6),
             _span("moe.dispatch", None, 0.1, 0.2, 0.2), _span("moe.dispatch", None, 1.0, 1.3, 0.3),
             _span("moe.route", None, 0.0, 0.1, 0.1),
             _span("train.clip", None, 2.0, 2.2, 0.1),
             _span("train.optimizer", None, 2.2, 3.0, 0.4),
             _span("mamba.scan.plain", None, 4.0, 4.5, 0.5),
             _span("mamba.scan.kernel", None, 5.0, 5.5, 0.25)])
    records = {"trace": {"busy_s": 2.0}}
    assert _read("train.moe_dispatch_pct", records) == pytest.approx(25.0)
    assert _read("train.optimizer_pct", records) == pytest.approx(25.0)
    assert _read("prefill.scan_pct", records) == pytest.approx(37.5)
    assert _read("prefill.scan_pct", {"trace": {}}) is None  # no busy time


def test_every_reader_gives_none_without_the_programs_store(program, monkeypatch):
    records = _serve_records(HAND_STEPS, HAND_EVENTS, 10.0)
    records["trace"]["busy_s"] = 6.0
    assert all(_read(name, records) is None for name in READERS)  # nothing put
    monkeypatch.undo()
    import repro_torch.core.timing as timing

    monkeypatch.delattr(timing, "trace_store")  # a program without the store
    assert program_spans.store() is None
    assert all(_read(name, records) is None for name in READERS)
