"""Whole runs of each cell on the CPU at the program's reduced sizes: a
sound program comes out correct, and each fault the cell can have, planted
where the timed path produces its answer, comes out not correct."""
import math

import pytest

from perfbench import calibrate
from perfbench.tests import tiny

CELLS = ["olmoe-1b-7b.serve.chat", "zamba2-7b.prefill.4k", "olmoe-1b-7b.train.4k"]
FAULTS = [("olmoe-1b-7b.serve.chat", "token"), ("olmoe-1b-7b.serve.chat", "cut_short"),
          ("zamba2-7b.prefill.4k", "answer"),
          ("olmoe-1b-7b.train.4k", "half_batch"), ("olmoe-1b-7b.train.4k", "unchanged")]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    result, checks = tiny.run(tiny.context(workload, seed=2**31 + 5, compute="float32"))
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_is_not_correct(workload, fault, monkeypatch):
    calibrate.plant(fault, monkeypatch.setattr)
    result, checks = tiny.run(tiny.context(workload, seed=77, compute="float32"))
    assert not result["correct"], checks


#: the served check at the reduced size: more served tokens than the cut
#: traffic gives, and its own limit, since the cell's (0.014) is set for the
#: full model in bfloat16 on the card, where the control reads 0.03-0.06;
#: the reduced model in float32 reads 0 to rounding, its control ~0.01
TINY_SERVE = {"limits": {"logit_gap_mean": 1e-3},
              "traffic": {"sample_min_tokens": 200,
                          "output_tokens": {"dist": "log_normal", "median": 14, "sigma": 0.4}}}


@pytest.mark.parametrize("seed", [91, 92])
@pytest.mark.parametrize("workload", CELLS)
def test_the_float8_control_reads_three_times_the_program(workload, seed):
    """The control at a size a test run holds, judged by the harness's own
    check in the program's place: it comes out not correct, and reads at
    least three times what the program reads on one of the cell's numbers
    (on the card, at the cell's size and in the program's bfloat16, its
    readings set the limits' upper ends)."""
    serve = workload == "olmoe-1b-7b.serve.chat"
    ctx = tiny.context(workload, seed=seed, compute="float32",
                       limits=TINY_SERVE["limits"] if serve else None)
    if serve:
        ctx.overrides["traffic"] = {**ctx.overrides["traffic"], **TINY_SERVE["traffic"]}
    result, checks = tiny.run(ctx, control=True)
    assert not result["correct"], checks
    r = ctx.readings
    assert any(r[f"control.{k}"] > 0 and r[f"control.{k}"] >= 3 * r[k]
               for k in ctx.cell.limits), r


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(workload):
    ctx = tiny.context(workload, seed=3, seconds=3.0, trace=True, compute="float32")
    result, _ = tiny.run(ctx)
    want = {m["name"] for m in ctx.cell.per_layer()}
    got = set(result["metrics"])
    # on the CPU no kernel of the card runs and no device memory is allocated:
    # the roofline and the peak have nothing to read
    assert got == want - {"flash_attention_roofline", "train.peak_gb"}
    assert result["device"]["window_s"] > 0 and result["device"]["busy_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["device_ops"]) <= 10


def test_a_request_that_never_starts_counts_as_worse_than_any(monkeypatch):
    """A request of the window whose first token never comes is missing:
    `failed` counts it, and the TTFT tail takes it as the whole wait."""
    import repro_torch.serve.engine as engine

    from perfbench import harness

    ctx = tiny.context("olmoe-1b-7b.serve.chat", seed=5, compute="float32")
    ctx.overrides["traffic"] = {**ctx.overrides["traffic"], "drain_limit_s": 0.3}
    submit, step = engine.ServeEngine.submit, engine.ServeEngine.step
    stalled = {"on": False}

    def submit_then_stall(self, *a, **k):  # the engine stops at the window's first send
        stalled["on"] = ctx.t_window is not None
        return submit(self, *a, **k)

    monkeypatch.setattr(engine.ServeEngine, "submit", submit_then_stall)
    monkeypatch.setattr(engine.ServeEngine, "step",
                        lambda self: None if stalled["on"] else step(self))
    driver = ctx.cell.driver()
    ctx.tracer = harness.Tracer(ctx.torch, False, False)
    outcome = driver.window(ctx, driver.setup(ctx))
    assert outcome.attempted >= 1 and outcome.failed == outcome.attempted
    assert outcome.end_to_end["ttft_p95_ms"] >= 300  # at least the wait it was given
