"""The port's serving launcher (``python -m repro_torch.launch.serve``) and
its scripted twin ``examples/serve_batch_torch.py`` on the CPU.

``main([...])`` with ``--device cpu`` over gemma-2b reduced: one engine
(dense and paged with a shared prefix), a health-monitored two-replica
cluster driven by the seeded chaos drill, and the refusals — an unknown
router (the message lists the registered names), ``--shared-prefix``
without ``--page-size``, ``--tp 2`` on one device, and the default
``--device cuda`` with no card visible, which exits non-zero without
touching the CPU.  The printed lines are the reference launcher's.
"""
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import serve as jlaunch
from repro_torch.launch import serve as tlaunch

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--arch", "gemma-2b", "--reduced", "--requests", "4", "--max-new", "5",
        "--max-len", "48", "--prefill-chunk", "4"]


def _line_heads(out: str) -> list:
    return [ln.split(":")[0].split(" ")[0] for ln in out.splitlines() if ln.strip()]


@pytest.mark.parametrize("extra", [
    [],
    ["--page-size", "8", "--shared-prefix", "6", "--slots", "3"],
    ["--replicas", "2", "--health", "--chaos", "--chaos-seed", "7"],
    ["--replicas", "2", "--router", "prefix_affinity", "--page-size", "8", "--shared-prefix", "6",
     "--deadline-s", "3600"],
])
def test_launcher_serves_every_request_and_prints_the_references_lines(capsys, extra):
    finished = tlaunch.main(BASE + ["--device", "cpu"] + extra)
    port = capsys.readouterr().out
    assert len(finished) == 4 and all(s.finish_reason == "max_new_tokens" for s in finished)
    assert all(len(s.out) == 5 for s in finished)
    ref = jlaunch.main(BASE + extra)
    assert len(ref) == 4
    assert _line_heads(port) == _line_heads(capsys.readouterr().out)
    if "--replicas" in extra:
        assert "cluster: 2 replica(s) x tp=1" in port and "robustness:" in port
    if "--chaos" in extra:
        assert "chaos: 4 scheduled fault(s)" in port
    if "--page-size" in extra:
        assert "prefix tokens reused" in port


@pytest.mark.parametrize("argv,match", [
    (["--router", "nope"], "registered: \\['least_loaded', 'prefix_affinity', 'round_robin'\\]"),
    (["--shared-prefix", "4"], "--shared-prefix requires --page-size"),
    (["--tp", "2"], "tensor-parallel degree 2 needs 2 devices, have 1"),
    (["--backend", "xla"], None),  # the port's backends are cuda and torch
])
def test_launcher_refusals(capsys, argv, match):
    with pytest.raises(SystemExit) as ei:
        tlaunch.main(BASE + ["--device", "cpu"] + argv)
    if match is None:
        assert ei.value.code == 2 and "invalid choice" in capsys.readouterr().err
    else:
        assert ei.value.code not in (0, None) and re.search(match, str(ei.value.code))


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(tlaunch, "build_model", lambda *a, **k: built.append(a))
    with pytest.raises(SystemExit, match="no CUDA device is visible"):
        tlaunch.main(BASE)
    assert not built  # refused before any model was built on the host


def test_launcher_module_exits_nonzero_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b", "--reduced"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                       "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device is visible" in proc.stderr
    assert "served" not in proc.stdout


@pytest.mark.parametrize("argv", [[], ["--replicas", "2", "--fail-one"]])
def test_serve_batch_example(capsys, argv):
    spec = importlib.util.spec_from_file_location(
        "serve_batch_torch", ROOT / "examples" / "serve_batch_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu"] + argv)
    out = capsys.readouterr().out
    assert "served 11 requests" in out and "streamed request got 10 tokens" in out
    if argv:
        assert "failed replica 0" in out and "1 failure(s)" in out
    with pytest.raises(SystemExit, match="requires --replicas"):
        example.main(["--device", "cpu", "--fail-one"])
