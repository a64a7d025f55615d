"""The port's spans and counters (``core.timing.span``, ``count``,
``trace_store``) on the CPU: off and empty while no profiler records; under
one, nested with their parents, in the profiler's host timeline as
``repro_torch.*`` function events (no user annotations), the store holding
only the newest traced stretch; and where the program records them: an
engine tick's phases with hand-worked counts, a MoE train step's phases and
the MoE's, the Mamba2 scan's route."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import serve as tserve
from repro_torch.configs import get_config
from repro_torch.core import timing
from repro_torch.data import DataPipeline
from repro_torch.models import build_model
from repro_torch.optim import AdamW, constant
from repro_torch.train.step import TrainState, make_train_step

CPU = [ProfilerActivity.CPU]


def _names(store, prefix=""):
    return [s["name"] for s in store["spans"] if s["name"].startswith(prefix)]


@pytest.fixture(autouse=True)
def _unprofiled_work_between_tests():
    """A span with no profiler, as the work between two profiling sessions
    runs: the next session's first span starts a new stretch."""
    timing.span("unprofiled")


def _model(name, **kw):
    cfg = get_config(name).reduced().replace(**kw)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# the facility
# ---------------------------------------------------------------------------
def test_without_a_profiler_a_span_is_the_shared_no_op_and_records_nothing():
    with profile(activities=CPU):  # a stretch that the next span must drop
        with timing.span("before"):
            timing.count("before", 1)
    with timing.span("a") as a, timing.span("b", device=torch.device("cpu")) as b:
        timing.count("c", 3)
    assert a is b is timing.span("d")
    with profile(activities=CPU):
        pass  # a profiler that records no span leaves the old stretch
    assert _names(timing.trace_store()) == ["before"]
    assert timing.trace_store()["counters"] == {"before": 1}
    with profile(activities=CPU):
        timing.count("fresh", 2)
    assert timing.trace_store() == {"spans": [], "counters": {"fresh": 2}}


def test_spans_nest_are_function_events_and_a_new_session_empties_the_store():
    with profile(activities=CPU) as prof:
        with timing.span("outer", tag=7):
            with timing.span("inner", device=torch.device("cpu")):
                torch.ones(4).sum()
                timing.count("n", 2)
                timing.count("n", 3)
            with timing.span("second", tag=8):
                pass
    store = timing.trace_store()
    spans = {s["name"]: s for s in store["spans"]}
    assert [s["name"] for s in store["spans"]] == ["outer", "inner", "second"]
    assert spans["outer"]["parent"] is None
    assert spans["inner"]["parent"] == spans["second"]["parent"] == spans["outer"]["id"]
    assert spans["inner"]["tag"] == 7 and spans["second"]["tag"] == 8  # inherited, given
    assert spans["outer"]["device_s"] is None  # a host span
    inner = spans["inner"]
    assert inner["device_s"] == pytest.approx(inner["end_s"] - inner["start_s"])
    assert spans["outer"]["start_s"] <= inner["start_s"] <= inner["end_s"] \
        <= spans["outer"]["end_s"]
    assert store["counters"] == {"n": 5}
    ours = [e for e in prof.events() if e.name.startswith("repro_torch.")]
    assert sorted(e.name for e in ours) == ["repro_torch.inner", "repro_torch.outer",
                                            "repro_torch.second"]
    assert not any(e.is_user_annotation for e in ours)
    # the next profiling session starts a new stretch
    timing.span("between")
    with profile(activities=CPU):
        with timing.span("later"):
            pass
    assert _names(timing.trace_store()) == ["later"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
ENGINE = dict(n_slots=4, max_len=32, prefill_chunk=4, page_size=4, guard="off")
TICK = ["engine.tick", "engine.admit", "engine.prefill", "engine.prefill.enqueue",
        "engine.prefill.enqueue", "engine.prefill.read", "engine.prefill.enqueue",
        "engine.prefill.read", "engine.grow", "engine.decode.enqueue", "engine.decode.wait",
        "engine.emit"]


@pytest.fixture(scope="module")
def gemma():
    return _model("gemma-2b")


def _serve(gemma, prompts, ticks, traced_tick=None):
    """The engine's tokens after ``ticks`` ticks; the tick ``traced_tick``
    (1-based) under the profiler."""
    _, model, params = gemma
    eng = tserve.ServeEngine(model, params, tserve.EngineConfig(**ENGINE))
    sessions = [eng.submit(p, 4) for p in prompts]
    for t in range(1, ticks + 1):
        if t == traced_tick:
            with profile(activities=CPU):
                eng.step()
        else:
            eng.step()
    return [s.out for s in sessions]


def test_one_paged_tick_records_its_phases_and_counts(gemma):
    """Prompts of 5 and 9 tokens, chunk 4, 4 lanes: 3 chunks of 4 tokens,
    computed on the lanes that feed each (2, 2, then 1 row), compute
    (2 + 2 + 1) x 4 = 20 slots for 14 fed tokens; the first prompt ends in
    chunk 2, the second in chunk 3.  The decode then holds 5 + 9 live
    positions against 4 lanes x 8 pages x 4 positions gathered."""
    prompts = [list(range(1, 6)), list(range(11, 20))]
    _serve(gemma, prompts, 1, traced_tick=1)
    store = timing.trace_store()
    assert _names(store, "engine.") == TICK
    spans = {}
    for s in store["spans"]:
        spans.setdefault(s["name"], []).append(s)
    tick = spans["engine.tick"][0]
    prefill = spans["engine.prefill"][0]
    for s in store["spans"]:
        assert s["tag"] == 1
        if s["name"] in ("engine.admit", "engine.prefill", "engine.grow",
                         "engine.decode.enqueue", "engine.decode.wait", "engine.emit"):
            assert s["parent"] == tick["id"]
        elif s["name"].startswith("engine.prefill."):
            assert s["parent"] == prefill["id"]
    assert store["counters"] == {"engine.prefill_fed": 14, "engine.prefill_slots": 20,
                                 "engine.kv_live": 14, "engine.kv_gathered": 128}


def test_a_dense_decode_counts_every_lane_to_max_len(gemma):
    """Tick 2 of the dense engine: no admission, one decode of the two
    lanes at 5 + 1 and 9 + 1 positions, against 4 lanes x 32."""
    _, model, params = gemma
    eng = tserve.ServeEngine(model, params, tserve.EngineConfig(
        **{**ENGINE, "page_size": None}))
    for p in ([1, 2, 3, 4, 5], list(range(11, 20))):
        eng.submit(p, 4)
    eng.step()
    with profile(activities=CPU):
        eng.step()
    store = timing.trace_store()
    assert _names(store, "engine.") == ["engine.tick", "engine.admit",
                                        "engine.decode.enqueue", "engine.decode.wait",
                                        "engine.emit"]
    assert store["counters"] == {"engine.kv_live": 16, "engine.kv_gathered": 128}


def test_the_engines_tokens_are_the_same_with_the_profiler_on_and_off(gemma):
    prompts = [list(range(1, 6)), list(range(11, 20)), [7, 7, 7]]
    assert _serve(gemma, prompts, 5, traced_tick=2) == _serve(gemma, prompts, 5)


# ---------------------------------------------------------------------------
# the train step, the MoE, the pipeline and the Mamba2 scan
# ---------------------------------------------------------------------------
def test_a_moe_train_step_records_its_phases_and_the_moes():
    """With remat, each layer's MoE runs in the forward and again in the
    backward's recompute: two of each ``moe.*`` span a layer."""
    cfg, model, params = _model("olmoe-1b-7b", remat=True)
    opt = AdamW()
    step = make_train_step(model.loss_fn, opt, constant(1e-3))
    rng = np.random.default_rng(0)
    pipe = DataPipeline(lambda i: {"tokens": rng.integers(1, cfg.vocab_size, (2, 16)),
                                   "targets": rng.integers(1, cfg.vocab_size, (2, 16))},
                        device="cpu", prefetch=1)
    state = TrainState(params, opt.init(params))
    try:
        with profile(activities=CPU):
            _, batch = next(pipe)
            state, metrics = step(state, batch)
    finally:
        pipe.close()
    store = timing.trace_store()
    names = _names(store)
    for phase in ("pipeline.wait", "train.step", "train.forward_backward", "train.clip",
                  "train.optimizer"):
        assert names.count(phase) == 1, names
    for part in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert names.count(part) == 2 * cfg.n_layers, names
    spans = {s["name"]: s for s in store["spans"]}
    assert [s["name"] for s in store["spans"] if s["parent"] == spans["train.step"]["id"]] \
        == ["train.forward_backward", "train.clip", "train.optimizer"]
    for phase in ("train.forward_backward", "train.clip", "train.optimizer", "moe.dispatch"):
        assert spans[phase]["device_s"] > 0  # host times stand in on the CPU
    assert torch.isfinite(metrics["loss"])


def test_without_grad_the_moe_times_its_spans_on_the_host_alone():
    """A serving step is paced by its host, where each CUDA event costs a
    record: the MoE's spans then carry no device time."""
    cfg, model, params = _model("olmoe-1b-7b")
    tokens = torch.arange(1, 17)[None]
    with torch.no_grad(), profile(activities=CPU):
        model.loss_fn(params, {"tokens": tokens, "targets": tokens})
    moe = [s for s in timing.trace_store()["spans"] if s["name"].startswith("moe.")]
    assert len(moe) == 4 * cfg.n_layers and all(s["device_s"] is None for s in moe)


@pytest.mark.parametrize("impl,call,route", [
    ("xla", "loss_fn", "mamba.scan.plain"),
    ("pallas", "loss_fn", "mamba.scan.kernel"),
    ("pallas", "prefill", "mamba.scan.plain"),  # stateful: the kernel has no state
])
def test_a_hybrid_forward_records_its_scans_route(impl, call, route):
    cfg, model, params = _model("zamba2-7b", ssm_impl=impl)
    rng = np.random.default_rng(1)
    tokens, targets = (torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 16)))
                       for _ in range(2))
    with torch.no_grad(), profile(activities=CPU):
        if call == "loss_fn":
            model.loss_fn(params, {"tokens": tokens, "targets": targets})
        else:
            model.prefill(params, {"tokens": tokens})
    names = _names(timing.trace_store(), "mamba.scan.")
    assert names == [route] * cfg.n_layers
