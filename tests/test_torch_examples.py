"""``examples/dissect_hardware_torch.py`` on the CPU: the paper as a program,
in quick mode with ``--device cpu``.  It prints the reference example's
sections (``examples/dissect_hardware.py``) plus the fit against the H100
datasheet record, and with no card visible its default ``--device cuda``
exits non-zero without measuring the host.
"""
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "dissect_hardware_torch.py"
SECTIONS = ("=== measured: cpu ===", "=== the fit vs the nvidia-h100-sxm datasheet record ===",
            "=== modeled: TPU v5e", "=== paper cross-check: T4 Table 3.1 constants ===",
            "=== spec DB: the fit vs the paper's T4 ===", "=== spec DB: T4 vs P4",
            "=== knowledge -> optimization (Ch.1) ===")


def test_dissect_example_quick_on_the_cpu(capsys, tmp_path):
    spec = importlib.util.spec_from_file_location("dissect_hardware_torch", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out_json = tmp_path / "report.json"
    example.main(["--device", "cpu", "--out", str(out_json)])
    out = capsys.readouterr().out
    at = [out.index(s) for s in SECTIONS]
    assert at == sorted(at)
    assert "fp32 peak ratio" in out and "autotuned (" in out
    report = json.loads(out_json.read_text())
    assert report["kind"] == "dissect_report" and report["mode"] == "measure"
    assert report["detected_levels"] and report["hardware"]["name"] == "measured-host"
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, str(EXAMPLE)], capture_output=True, text=True,
                              timeout=120, env={"PYTHONPATH": str(ROOT / "src"),
                                                "PATH": "/usr/bin:/bin"})
        assert proc.returncode != 0 and "no CUDA device is visible" in proc.stderr
        assert "measured" not in proc.stdout


def test_example_imports_no_jax_and_no_reference():
    source = EXAMPLE.read_text()
    assert "repro_torch" in source
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b(?!_)", source, re.MULTILINE)
