"""The paper's other suites (instr, bandwidth, axpy, memhier, scheduler,
atomics, throttle) and ``core/throttle.py`` against the reference's on the
CPU (``device="cpu"``).  The records keep the reference's names, units,
``x``, ``better`` and ``measured`` flags, and the modeled rows its values;
the port's ``torch`` variant plays the reference's ``xla`` one.  The
``cuda`` variants need the card, so on the CPU each measures nothing and says
so in its suite's ``*_skipped`` row.  The slow reference suites (memhier,
bandwidth, axpy: pointer chases and Pallas interpret mode) run on the same
reduced grid in both packages; the rest, and every variant, on their quick
grids."""
import dataclasses

import numpy as np
import pytest

from repro.bench import compat as jcompat
from repro.bench import runner as jrunner
from repro.core import registry as jregistry
from repro.core import throttle as jthrottle
from repro_torch.bench import cli as tcli
from repro_torch.bench import compat as tcompat
from repro_torch.bench import runner as trunner
from repro_torch.bench.schema import BenchResult
from repro_torch.core import registry as tregistry
from repro_torch.core import throttle as tthrottle

jrunner.load_suites()
trunner.load_suites()

# the same overrides in both packages, for the suites whose reference runs
# take tens of seconds on the CPU at the quick grid
REDUCED = {
    "memhier": {"max_pow": 16},
    "bandwidth": {"max_pow": 20, "block_footprint": 1 << 16},
    "axpy": {"sizes": (1 << 14,), "widths": (128, 256)},
}
PLAIN = ("instr", "bandwidth", "axpy", "memhier", "scheduler", "atomics")
VARIANTS = ("bandwidth", "axpy", "memhier", "scheduler")


def _level(r) -> bool:
    """A memhier plateau row: how many the curve shows depends on the host."""
    return r.name.startswith("pchase_host_level")


def _shape(recs) -> list:
    """(name with the variant tag as the reference's, unit, x, better,
    measured) of each record but the plateau rows."""
    return [(r.name.replace("[torch]", "[xla]"), r.unit, r.x, r.better, r.measured)
            for r in recs if not _level(r)]


def _modeled(recs) -> dict:
    return {r.name: r.value for r in recs if not r.measured}


def _run(registry, name, extra=None):
    return registry.get(name).run("quick", {**REDUCED.get(name, {}), **(extra or {})})


@pytest.mark.parametrize("name", PLAIN)
def test_plain_suite_records_match_the_reference(name):
    want = _run(jregistry, name)
    got = _run(tregistry, name, {"device": "cpu"})
    assert _shape(got) == _shape(want) and got
    assert _modeled(got) == _modeled(want)
    assert all(np.isfinite(r.value) and r.value > 0 for r in got if r.measured)
    assert all((r.unit, r.better, r.measured) == ("ns", "info", True) for r in got if _level(r))


@pytest.mark.parametrize("name", VARIANTS)
def test_torch_variant_matches_the_references_xla_variant(name):
    want = _run(jregistry, f"{name}[xla]")
    got = _run(tregistry, f"{name}[torch]", {"device": "cpu"})
    assert _shape(got) == _shape(want) and got
    assert all(r.name.endswith("[torch]") and "torch backend" in r.info for r in got)
    assert all(np.isfinite(r.value) and r.value > 0 for r in got)


@pytest.mark.parametrize("name", VARIANTS)
def test_cuda_variant_on_the_cpu_measures_nothing(name):
    spec = tregistry.get(f"{name}[cuda]")
    (rec,) = spec.run("quick", {"device": "cpu"})
    points = len(_run(tregistry, f"{name}[torch]", {"device": "cpu"}))
    assert rec.name == f"{name}_skipped[cuda]" and rec.value == points
    assert (rec.unit, rec.better, rec.measured) == ("points", "info", True)
    assert "card" in rec.info


@pytest.mark.parametrize("mode", ["quick", "full"])
def test_throttle_records_equal_the_references(mode):
    want = jregistry.get("throttle").run(mode)
    got = tregistry.get("throttle").run(mode)
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert len(got) == (14 if mode == "quick" else 20) and not any(r.measured for r in got)


@pytest.mark.parametrize("part", ["T4_THROTTLE", "V5E_THROTTLE"])
@pytest.mark.parametrize("util", [0.0, 0.3, 0.75, 1.0])
def test_throttle_model_equals_the_references_bit_for_bit(part, util):
    tp, jp = getattr(tthrottle, part), getattr(jthrottle, part)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    got = tthrottle.simulate(tp, util, duration_s=120.0, dt=0.25)
    want = jthrottle.simulate(jp, util, duration_s=120.0, dt=0.25)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert tthrottle.steady_state_clock(tp, util) == jthrottle.steady_state_clock(jp, util)
    assert tthrottle.slowdown_factor(tp, util) == jthrottle.slowdown_factor(jp, util)


def test_legacy_rows_equal_the_references():
    """The old CSV rows of the same records, one of each unit the suites
    emit and of the units legacy_row converts."""
    from repro.bench.schema import BenchRecord as JRecord
    from repro_torch.bench.schema import BenchRecord as TRecord

    assert tcompat.legacy_rows("throttle") == jcompat.legacy_rows("throttle")
    cases = [
        dict(name="a", benchmark="b", x=1, value=2.5, unit=u, metrics=m, info=i)
        for u in ("us", "us/call", "ns", "ns/load", "ns/op", "s", "GB/s", "points")
        for m, i in (({}, ""), ({"us_per_call": 7.0}, "derived"))
    ]
    for c in cases:
        assert tcompat.legacy_row(TRecord(**c)) == jcompat.legacy_row(JRecord(**c))


def test_cli_runs_every_paper_suite_on_the_cpu(tmp_path, capsys):
    """``run`` over all seven suites on the CPU: every registered variant
    reports, none errors, the cuda variants skip, and the gate passes the
    run against its own baselines."""
    out = tmp_path / "r.json"
    names = ["instr", "bandwidth", "axpy", "memhier", "scheduler", "atomics", "throttle"]
    assert tcli.main(["run", *names, "--device", "cpu", "--out", str(out)]) == 0
    result = BenchResult.load(out)
    assert not result.errors
    assert set(result.timings) == set(trunner.select(names)) and len(result.timings) == 15
    skipped = sorted(r.name for r in result.records if "skipped" in r.name)
    assert skipped == [f"{n}_skipped[cuda]" for n in ("axpy", "bandwidth", "memhier",
                                                      "scheduler")]
    assert tcli.main(["baseline", str(out), "--out-dir", str(tmp_path / "b")]) == 0
    capsys.readouterr()
    assert tcli.main(["compare", str(out), str(tmp_path / "b")]) == 0
    assert capsys.readouterr().out.rstrip().endswith("PASS")
