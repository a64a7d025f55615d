"""BENCHMARK.json against the contract's shape; a new cell, configuration,
traffic mix and per-layer metric added as files and entries alone; no run
loads JAX or the JAX package; the command refuses a host without a card."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench import harness
from perfbench.tests import tiny

ROOT = tiny.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_spec_has_the_contracts_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"] and 1 <= SPEC["run_seconds"] <= 51
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["source"] in ("device_trace", "host_clock")
    for w in SPEC["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        names = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer()


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    # a configuration, a traffic mix, a cell, its limits and a per-layer metric
    cfg = json.loads((ROOT / "perfbench/configs/olmoe-1b-7b.json").read_text())
    cfg["name"] = "olmoe-1b-7b-copy"
    (root / "perfbench/configs/olmoe-1b-7b-copy.json").write_text(json.dumps(cfg))
    chat = json.loads((ROOT / "perfbench/traffic/chat.json").read_text())
    chat["output_tokens"] = {"dist": "log_normal", "median": 8, "sigma": 0.4}
    (root / "perfbench/traffic/short_chat.json").write_text(json.dumps(chat))
    (root / "perfbench/limits/olmoe-1b-7b-copy.short.json").write_text(
        (ROOT / "perfbench/limits/olmoe-1b-7b.serve.chat.json").read_text())
    (root / "perfbench/metrics/serve.requests.py").write_text(
        "def read(records):\n    return sum(r['in_window'] for r in records['requests'])\n")
    spec["configs"].append({**spec["configs"][0], "name": "olmoe-1b-7b-copy",
                            "file": "perfbench/configs/olmoe-1b-7b-copy.json"})
    spec["workloads"].append({"name": "olmoe-1b-7b-copy.short", "config": "olmoe-1b-7b-copy",
                              "traffic": "short_chat", "chips": 1, "why": "a test's cell"})
    spec["end_to_end"][0]["workloads"].append("olmoe-1b-7b-copy.short")
    spec["per_layer"].append({"name": "serve.requests", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "client", "moves": "serve_tok_s",
                              "workloads": ["olmoe-1b-7b-copy.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    ctx = tiny.context("olmoe-1b-7b-copy.short", trace=True, compute="float32", root=root)
    result, _ = tiny.run(ctx)
    assert result["correct"]
    assert result["metrics"]["serve.requests"]["value"] == result["attempted"] > 0


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.tests import tiny\n"
            "from perfbench import harness\n"
            "for w in ('olmoe-1b-7b.serve.chat', 'zamba2-7b.prefill.4k'):\n"
            "    tiny.run(tiny.context(w, compute='float32'))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded, forbidden = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert "'repro_torch'" in loaded  # whole names: repro_torch is not repro
    for name in ("jax", "jaxlib", "flax", "repro", "benchmarks"):
        assert f"'{name}'" not in loaded


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def _command(cwd: Path):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "zamba2-7b.prefill.4k", "--seed", str(2**31 + 3), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=cwd)


def test_the_command_gives_no_result_without_a_card():
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_the_command_gives_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
