"""``examples/dissect_hardware_torch.py`` on the CPU: the paper as a program,
in quick mode with ``--device cpu``.  It prints the reference example's
sections (``examples/dissect_hardware.py``) plus the fit against the H100
datasheet record, and with no card visible its default ``--device cuda``
exits non-zero without measuring the host.  The two training examples
(``train_tiny_lm_torch.py``, ``quickstart_torch.py``) run small on the CPU
the same way: the injected failure and resume, and one autograd step.
"""
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
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


# ---------------------------------------------------------------------------
# the two training examples, small, on the CPU
# ---------------------------------------------------------------------------
TRAIN_EXAMPLES = {name: ROOT / "examples" / f"{name}.py"
                  for name in ("train_tiny_lm_torch", "quickstart_torch")}


def _load(name):
    spec = importlib.util.spec_from_file_location(name, TRAIN_EXAMPLES[name])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_tiny_lm_example_fails_over_and_resumes_on_the_cpu(capsys):
    """The resumed run's losses equal an uninterrupted run's bit for bit."""
    from repro_torch.data import DataPipeline
    from repro_torch.train.loop import LoopConfig, train_loop

    example = _load("train_tiny_lm_torch")
    argv = ["--device", "cpu", "--steps", "20", "--d-model", "64", "--layers", "1", "--seq",
            "32", "--batch", "4", "--vocab", "256"]
    hist = example.main(argv)
    out = capsys.readouterr().out
    assert "!! injected failure at step 10 — resuming from last checkpoint" in out
    assert hist[0]["step"] == 10 and hist[-1]["step"] == 19  # resumed from the step-10 save
    assert hist[-1]["loss"] < hist[0]["loss"] and "done: loss" in out
    step_fn, fresh_state, src = example.make_run(example.parse_args(argv), torch.device("cpu"))
    _, whole = train_loop(step_fn, fresh_state(), DataPipeline(src.batch_at, prefetch=0,
                                                               device="cpu"),
                          cfg=LoopConfig(total_steps=20))
    assert [h["loss"] for h in whole[10:]] == [h["loss"] for h in hist]


def test_quickstart_example_on_the_cpu(capsys):
    loss, loss2 = _load("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    for section in ("== dissecting cpu (quick probes) ==", "== nvidia-h100-sxm model",
                    "== autotuned tiles for 4096^3 bf16 matmul on nvidia-h100-sxm",
                    "after one step ==", "== decoded one token per sequence:"):
        assert section in out
    assert loss2 < loss


@pytest.mark.parametrize("name", sorted(TRAIN_EXAMPLES))
def test_training_examples_need_the_card_unless_asked_and_import_no_jax(name):
    source = TRAIN_EXAMPLES[name].read_text()
    assert "repro_torch" in source
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b(?!_)", source, re.MULTILINE)
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, str(TRAIN_EXAMPLES[name])], capture_output=True,
                              text=True, timeout=120, env={"PYTHONPATH": str(ROOT / "src"),
                                                           "PATH": "/usr/bin:/bin"})
        assert proc.returncode != 0 and "no CUDA device is visible" in proc.stderr
        assert "loss" not in proc.stdout
