"""The slice as a whole against the reference: model-mode dissection, and
measure mode with one deterministic timer stubbed into both packages, must
give the same probe curves, detected levels and fitted model; the bench
suite must emit the same record names.  Also: entry points never fall back
to the CPU on their own."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core.dissect as jdissect
import repro.core.pchase as jpc
import repro.core.probes as jprobes
import repro.hw as jhw
import repro_torch.core.dissect as tdissect
import repro_torch.core.pchase as tpc
import repro_torch.core.probes as tprobes
import repro_torch.hw as thw
from repro.bench.suites import dissect as jsuite
from repro_torch.bench import runner as trunner
from repro_torch.bench import schema as tschema
from repro_torch.bench.suites import dissect as tsuite
from repro_torch.core.timing import NoCudaDeviceError, resolve_device, time_fn


@pytest.mark.parametrize("hw", ["tpu-v5e", "T4", "h100"])
def test_dissect_model_equal(hw):
    got, want = tdissect.dissect_model(hw), jdissect.dissect_model(hw)
    assert got.mode == want.mode == "model"
    assert got.probe_results == want.probe_results
    assert got.detected_levels == want.detected_levels
    assert got.hardware.to_json() == want.hardware.to_json()


def test_dissect_compare_equal():
    assert tdissect.dissect_compare() == jdissect.dissect_compare()
    parts = ("T4", "A100", "H100", "tpu-v5e")
    assert tdissect.dissect_compare(parts, baseline="h100") == jdissect.dissect_compare(
        parts, baseline="h100"
    )


def _stub_time_fn(fn, *args, warmup=3, reps=10, **kw):
    """A staircase in the first argument's byte size, so plateaus appear."""
    nb = int(args[0].nbytes)
    level = 1.0 if nb <= 64 << 10 else 6.0 if nb <= 2 << 20 else 40.0
    s = level * 1e-4 * (1 + nb / (1 << 30))
    return SimpleNamespace(min_s=s, median_s=s, mean_s=s, reps=reps)


def _stub_perm(n, seed=0):
    return np.roll(np.arange(n, dtype=np.int32), -1)


@pytest.fixture
def stubbed(monkeypatch):
    for mod in (jprobes, tprobes):
        monkeypatch.setattr(mod, "time_fn", _stub_time_fn)
    for mod in (jpc, tpc):
        monkeypatch.setattr(mod, "single_cycle_permutation", _stub_perm)
    yield
    for db in (jhw, thw):
        db.unregister("measured-host")


def _without_backend(probe_results):
    out = {}
    for name, d in probe_results.items():
        meta = {k: v for k, v in d["meta"].items() if k != "backend"}
        out[name] = {**d, "meta": meta}
    return out


def test_dissect_measure_parity_with_stubbed_timer(stubbed):
    want = jdissect.dissect_measure(quick=True)
    got = tdissect.dissect_measure(quick=True, device="cpu")
    assert _without_backend(got.probe_results) == _without_backend(want.probe_results)
    assert len(got.detected_levels) >= 2
    assert got.detected_levels == want.detected_levels
    assert got.hardware.to_json() == want.hardware.to_json()
    assert thw.get("measured-host").to_json() == jhw.get("measured-host").to_json()
    for probe in ("pointer_chase", "stream_bandwidth", "matmul_throughput"):
        assert got.probe_results[probe]["meta"]["backend"] == "torch"
    doc = json.loads(got.to_json())
    assert doc["schema_version"] == 1 and doc["env"]["backend"] == "cpu"


def test_bench_dissect_record_names_match_reference(stubbed):
    want = jsuite.bench_dissect(quick=True)
    got = tsuite.bench_dissect(quick=True, device="cpu")
    assert [r.name for r in got] == [r.name for r in want]
    assert [(r.value, r.unit, r.better, r.measured) for r in got] == [
        (r.value, r.unit, r.better, r.measured) for r in want
    ]
    res = trunner.run_benchmarks(only=["dissect"], device="cpu")
    assert not res.errors
    tschema.validate_result(res.to_dict())
    assert [r.name for r in res.records] == [r.name for r in want]


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device runs")
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        tdissect.dissect_measure()
    with pytest.raises(NoCudaDeviceError):
        tprobes.probe_pointer_chase([4096], steps=4)
    with pytest.raises(NoCudaDeviceError):
        trunner.run_benchmarks(only=["dissect"])
    with pytest.raises(NoCudaDeviceError):
        time_fn(lambda: None, device="cuda")


def test_time_fn_cpu_clock():
    t = time_fn(torch.add, torch.ones(4), torch.ones(4), warmup=1, reps=3)
    assert t.reps == 3 and 0 < t.min_s <= t.median_s
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")
