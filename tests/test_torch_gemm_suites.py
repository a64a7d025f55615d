"""The ``gemm`` and ``gemm_lp`` bench suites against the reference's on the
CPU (quick grids, ``--device cpu``): the same record names, units and ``x``,
and the modeled rows' values equal.  The port's ``torch`` variant plays the
reference's ``xla`` one; its ``cuda`` variant needs the card, so on the CPU
it measures nothing and says so in its suite's ``*_skipped`` row."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.bench.schema import validate_result
from repro.bench.suites import gemm as jgemm
from repro.bench.suites import gemm_lp as jgemm_lp
from repro.core import registry as jregistry
from repro_torch.bench import runner as trunner
from repro_torch.bench.suites import gemm as tgemm
from repro_torch.bench.suites import gemm_lp as tgemm_lp
from repro_torch.core import registry as tregistry

ROOT = Path(__file__).resolve().parents[1]
QUICK_LP = dict(sizes=(128, 256), dtypes=("float32", "bfloat16", "int8"))


def _shape(recs) -> list:
    """(name without its variant tag, unit, x, measured) of each record."""
    return [(r.name.split("[")[0], r.unit, r.x, r.measured) for r in recs]


def _modeled(recs) -> dict:
    return {r.name.split("[")[0]: r.value for r in recs if not r.measured}


def test_gemm_records_match_the_reference():
    want = jgemm.bench_gemm(sizes=(256, 512))
    got = tgemm.bench_gemm(sizes=(256, 512), device="cpu")
    assert _shape(got) == _shape(want)
    assert _modeled(got) == _modeled(want) and len(_modeled(got)) == 12


def test_gemm_torch_variant_matches_the_references_xla_variant():
    want = jregistry.get("gemm[xla]").run("quick")
    got = tregistry.get("gemm[torch]").run("quick", {"device": "cpu"})
    assert _shape(got) == _shape(want)
    assert [r.name for r in got] == ["gemm_dispatch_float32:256[torch]",
                                     "gemm_dispatch_float32:512[torch]"]
    assert all(r.value > 0 for r in got)


def test_gemm_cuda_variant_on_the_cpu_measures_nothing():
    (rec,) = tregistry.get("gemm[cuda]").run("quick", {"device": "cpu"})
    assert rec.name == "gemm_skipped[cuda]" and rec.value == 2.0 and "card" in rec.info


def test_gemm_lp_records_match_the_reference():
    want = jgemm_lp.bench_gemm_lp(**QUICK_LP, backend="xla")
    got = tgemm_lp.bench_gemm_lp(**QUICK_LP, backend="torch", device="cpu")
    assert _shape(got) == _shape(want)
    assert _modeled(got) == _modeled(want)
    assert not any(r.name == "gemm_lp_skipped" for r in got)
    assert all(r.value > 0 for r in got)


@pytest.mark.parametrize("hw", ["T4", "h100", "tpu-v5e"])
def test_gemm_lp_modeled_ladder_matches_for_each_part(hw):
    want = jgemm_lp.bench_gemm_lp(sizes=(128,), dtypes=("float32",), hw=hw, backend="xla")
    got = tgemm_lp.bench_gemm_lp(sizes=(128,), dtypes=("float32",), hw=hw, backend="torch",
                                 device="cpu")
    assert _modeled(got) == _modeled(want) and _modeled(got)


def test_gemm_lp_cuda_variant_on_the_cpu_skips_every_point():
    recs = tregistry.get("gemm_lp[cuda]").run("quick", {"device": "cpu"})
    want = jgemm_lp.bench_gemm_lp(**QUICK_LP, backend="xla")
    assert _modeled(recs) == _modeled(want)
    (skip,) = [r for r in recs if r.name.startswith("gemm_lp_skipped")]
    assert skip.value == 6.0 and "float32:128" in skip.info
    assert all(not r.measured or r.name.startswith("gemm_lp_skipped") for r in recs)


def test_grids_and_variants_are_the_references():
    for name in ("gemm", "gemm_lp"):
        for jname, tname in ((name, name), (f"{name}[xla]", f"{name}[torch]"),
                             (f"{name}[pallas]", f"{name}[cuda]")):
            if jname == name and name == "gemm_lp":
                continue
            j, t = jregistry.get(jname), tregistry.get(tname)
            assert (t.quick, t.full, t.paper_ref) == (j.quick, j.full, j.paper_ref)
    assert {n for n in trunner.select(["gemm"])} == {
        "gemm", "gemm[cuda]", "gemm[torch]", "gemm_lp[cuda]", "gemm_lp[torch]"}


@pytest.mark.parametrize("suite", ["gemm_lp", "gemm"])
def test_cli_run_on_the_cpu_exits_0(suite, tmp_path):
    out = tmp_path / "r.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench", "run", suite, "--device", "cpu", "--out",
         str(out)], cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.read_text())
    validate_result(doc)
    assert not doc["errors"]
    names = {r["name"] for r in doc["records"]}
    assert "gemm_lp_float32:128[torch]" in names and "gemm_lp_skipped[cuda]" in names
