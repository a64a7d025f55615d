"""The port's baseline store, regression gate and trend report against the
reference's on the same schema-v1 files: the reference's checked-in
``benchmarks/baselines/*.json``, and results files written by the reference
(values equal to those baselines, then one record doubled, one rate halved,
a modeled row moved past its 2 %).  Both packages must give the same report
(pass/fail, deltas, thresholds), the same baseline files and the same trend
series; the CLIs the same output and exit codes.  Also the port's own
``benchmarks/baselines_torch/``: written on the card, they load, cover every
ported suite and name an H100."""
import dataclasses
import json
from pathlib import Path

import pytest

from repro.bench import baseline as jbl
from repro.bench import cli as jcli
from repro.bench import trend as jtrend
from repro.bench.schema import BenchRecord as JRecord
from repro.bench.schema import BenchResult as JResult
from repro.bench.schema import SchemaError as JSchemaError
from repro.core.serialization import EnvFingerprint as JEnv
from repro_torch.bench import baseline as tbl
from repro_torch.bench import cli as tcli
from repro_torch.bench import runner as trunner
from repro_torch.bench import trend as ttrend
from repro_torch.bench.schema import BenchResult as TResult
from repro_torch.bench.schema import SchemaError

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"
PORT_BASELINES = ROOT / "benchmarks" / "baselines_torch"
ENV = JEnv(jax_version="0.4.37", jaxlib_version="0.4.36", backend="cpu", device_kind="cpu",
           device_count=1, platform="Linux", python_version="3.12.0")


def _baseline_records() -> list:
    """Every record of the reference's baselines, as result records."""
    recs = []
    for p in sorted(BASELINES.glob("*.json")):
        doc = json.loads(p.read_text())
        recs += [JRecord(name=r["name"], benchmark=doc["benchmark"], x=None, value=r["value"],
                         unit=r["unit"], better=r["better"], measured=r["measured"])
                 for r in doc["records"]]
    return recs


def _scaled(recs, factors: dict) -> list:
    return [dataclasses.replace(r, value=r.value * factors.get(r.name, 1.0)) for r in recs]


def _pick(recs, better, measured):
    """A record to move; the first two are the ones the cases drop."""
    return next(r.name for r in recs[2:] if r.better == better and r.measured is measured)


RECS = _baseline_records()
CASES = {
    "equal": {},
    "latency_doubled": {_pick(RECS, "lower", True): 2.0},
    "rate_halved": {_pick(RECS, "higher", True): 0.5},
    "modeled_moved_3pct": {_pick(RECS, "higher", False): 0.97},
    "improved": {_pick(RECS, "lower", True): 0.1},
}


def _write_result(path, factors, errors=None, drop=(), created_at="") -> Path:
    recs = [r for r in _scaled(RECS, factors) if r.name not in drop]
    recs.append(JRecord(name="brand_new_row", benchmark="instr", x=None, value=1.0, unit="ns/op"))
    res = JResult(mode="quick", env=ENV, records=recs, errors=dict(errors or {}),
                  created_at=created_at)
    res.save(path)
    return path


def test_both_packages_load_the_same_baseline_table():
    want, got = jbl.load_baselines(BASELINES), tbl.load_baselines(BASELINES)
    assert got.keys() == want.keys() and len(got) == len(RECS)
    for name, (bench, rec) in want.items():
        assert (got[name][0], dataclasses.asdict(got[name][1])) == (bench,
                                                                    dataclasses.asdict(rec))
        assert got[name][1].effective_threshold() == rec.effective_threshold()


@pytest.mark.parametrize("scale", [1.0, 0.5, 2.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_gives_the_references_report(tmp_path, case, scale):
    path = _write_result(tmp_path / "r.json", CASES[case], drop=(RECS[0].name,))
    want = jbl.compare_files(path, BASELINES, threshold_scale=scale)
    got = tbl.compare_files(path, BASELINES, threshold_scale=scale)
    assert got.to_dict() == want.to_dict()
    assert got.format() == want.format()
    assert got.new_records == ["brand_new_row"] and got.missing_records == [RECS[0].name]
    if case in ("latency_doubled", "rate_halved") and scale <= 1.0:
        assert not got.passed
    if case == "equal":
        assert got.passed


def test_compare_reports_errors_zero_baselines_and_overrides_as_the_reference(tmp_path):
    base = tmp_path / "b"
    base.mkdir()
    doc = {"schema_version": 1, "benchmark": "x", "records": [
        {"name": "zero", "value": 0.0, "unit": "ns", "better": "lower"},
        {"name": "tight", "value": 10.0, "unit": "GB/s", "better": "higher", "threshold": 0.01},
        {"name": "rate_to_zero", "value": 10.0, "unit": "GB/s", "better": "higher"},
    ]}
    (base / "x.json").write_text(json.dumps(doc))
    recs = [JRecord(name="zero", benchmark="x", x=None, value=3.0, unit="ns"),
            JRecord(name="tight", benchmark="x", x=None, value=9.8, unit="GB/s"),
            JRecord(name="rate_to_zero", benchmark="x", x=None, value=0.0, unit="GB/s")]
    path = tmp_path / "r.json"
    JResult(mode="quick", env=ENV, records=recs, errors={"gemm": "boom"}).save(path)
    want, got = jbl.compare_files(path, base), tbl.compare_files(path, base)
    assert got.to_dict() == want.to_dict() and not got.passed
    assert got.zero_baselines == ["zero"] and len(got.regressions) == 2


def test_write_baselines_writes_the_references_records(tmp_path):
    path = _write_result(tmp_path / "r.json", {})
    jpaths = jbl.write_baselines(JResult.load(path), tmp_path / "j")
    tpaths = tbl.write_baselines(TResult.load(path), tmp_path / "t")
    assert [p.name for p in tpaths] == [p.name for p in jpaths]
    for jp, tp in zip(jpaths, tpaths):
        jdoc, tdoc = json.loads(jp.read_text()), json.loads(tp.read_text())
        # the env is each package's own fingerprint; the rest is the same
        assert {k: v for k, v in tdoc.items() if k != "generated_from"} == {
            k: v for k, v in jdoc.items() if k != "generated_from"}
        assert tdoc["generated_from"]["mode"] == jdoc["generated_from"]["mode"]
        assert tdoc["generated_from"]["env"]["device_kind"] == "cpu"
    assert tbl.load_baselines(tmp_path / "t").keys() == jbl.load_baselines(tmp_path / "j").keys()


@pytest.mark.parametrize("as_json", [False, True])
@pytest.mark.parametrize("prefixes", [None, ["instr"], ["oplat_add", "throttle"]])
def test_trend_gives_the_references_series(tmp_path, as_json, prefixes):
    art = tmp_path / "art"
    art.mkdir()
    _write_result(art / "BENCH_aaaa1111.json", {}, created_at="2026-01-01T00:00:00")
    _write_result(art / "BENCH_bbbb2222.json", CASES["latency_doubled"],
                  created_at="2026-01-02T00:00:00")
    _write_result(art / "BENCH_CHAOS_bbbb2222.json", CASES["rate_halved"],
                  created_at="2026-01-02T00:00:00")
    _write_result(art / "BENCH_cccc3333.json", CASES["improved"], drop=(RECS[1].name,),
                  created_at="2026-01-03T00:00:00")
    fmt = "format_json" if as_json else "format_markdown"
    reports = []
    for mod in (jtrend, ttrend):
        commits = mod.load_commits(mod.discover([art]))
        reports.append(getattr(mod, fmt)(mod.build_trend(commits, benchmarks=prefixes)))
    assert reports[1] == reports[0]
    assert "cccc3333" in reports[0]


def test_trend_refuses_a_malformed_file_as_the_reference(tmp_path):
    bad = tmp_path / "BENCH_dddd4444.json"
    bad.write_text(json.dumps({"schema_version": 1, "mode": "quick", "env": {}, "records": {}}))
    for mod, error in ((jtrend, JSchemaError), (ttrend, SchemaError)):
        with pytest.raises(error, match="records must be a list"):
            mod.load_commits([bad])


def test_port_loads_a_result_only_with_a_known_env(tmp_path):
    path = _write_result(tmp_path / "r.json", {})
    doc = json.loads(path.read_text())
    assert TResult.load(path).env.device_kind == "cpu"
    doc["env"] = {"who": "else"}
    with pytest.raises(SchemaError, match="env keys"):
        TResult.from_dict(doc)


@pytest.mark.parametrize("argv,rc", [
    (["compare", "{r}", "{b}"], 1), (["compare", "{r}", "{b}", "--json"], 1),
    (["compare", "{r}", "{b}", "--warn-only"], 0),
    (["compare", "{r}", "{b}", "--threshold-scale", "3"], 0),
    (["compare", "{r}", "{tmp}/missing"], 2), (["compare", "{tmp}/missing.json", "{b}"], 2),
    (["trend", "{tmp}/art"], 0), (["trend", "{tmp}/art", "--json", "--benchmark", "instr"], 0),
    (["trend", "{tmp}/empty"], 2),
])
def test_cli_output_and_exit_codes_match_the_reference(tmp_path, capsys, argv, rc):
    """The result has one latency doubled: the gate fails (1) unless told to
    warn only or loosened 3x; a missing input exits 2; ``trend`` reports (0)
    and exits 2 only when it finds no file."""
    (tmp_path / "art").mkdir()
    (tmp_path / "empty").mkdir()
    r = _write_result(tmp_path / "r.json", CASES["latency_doubled"])
    _write_result(tmp_path / "art" / "BENCH_aaaa1111.json", {}, created_at="2026-01-01")
    _write_result(tmp_path / "art" / "BENCH_bbbb2222.json", CASES["rate_halved"],
                  created_at="2026-01-02")
    args = [a.format(r=r, b=BASELINES, tmp=tmp_path) for a in argv]
    outs = []
    for cli in (jcli, tcli):
        code = cli.main(args)
        outs.append((code, *capsys.readouterr()))
    assert outs[1] == outs[0]
    assert outs[0][0] == rc


def test_baseline_cli_writes_where_it_is_told(tmp_path, capsys):
    r = _write_result(tmp_path / "r.json", {})
    assert tcli.main(["baseline", str(r), "--out-dir", str(tmp_path / "t")]) == 0
    assert jcli.main(["baseline", str(r), "--out-dir", str(tmp_path / "j")]) == 0
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())
    assert capsys.readouterr().out.count("wrote ") == 2 * len(list((tmp_path / "t").iterdir()))


def test_port_baselines_cover_every_ported_suite_from_an_h100():
    """``benchmarks/baselines_torch/``: schema v1, one file per registered
    benchmark of the port (the [torch] variants too), written from a
    ``--quick`` run on the card, whose fingerprint names an H100."""
    table = tbl.load_baselines(PORT_BASELINES)
    files = sorted(p.stem for p in PORT_BASELINES.glob("*.json"))
    assert files == trunner.select() and table
    for p in PORT_BASELINES.glob("*.json"):
        doc = json.loads(p.read_text())
        env = doc["generated_from"]["env"]
        assert doc["generated_from"]["mode"] == "quick" and doc["benchmark"] == p.stem
        assert env["backend"] == "cuda" and "H100" in env["device_kind"], env
        assert all(r["better"] in ("lower", "higher") and r["value"] != 0
                   for r in doc["records"])
