"""``repro_torch.launch.dryrun`` and ``launch.cell.cost_reference``.

``cost_reference`` runs the reference's loop-free variant of a cell once on
``meta`` under ``perfmodel.extract_costs``; it must come within 10 % of the
reference's ``global_flops`` for a reduced dense and MoE model at each kind.
Not closer: XLA counts one FLOP an element for elementwise ops (the
norms, the softmax, the optimizer's update), where the port's counter
(``torch.utils.flop_counter``) counts matmuls and attention alone, as
``tests/test_torch_perfmodel.py`` sets out.

The CLI must write the reference's record keys for a cell it runs and the
reference's skip record for a shape a full-attention arch does not take.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.launch.cell import cost_reference as jcost_reference
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.cell import build_cell, cost_reference
from repro_torch.launch.mesh import make_test_mesh

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
RECORD_KEYS = {"cell", "hw", "arch", "shape", "mesh", "chips", "kind", "n_params",
               "n_params_active", "lower_s", "compile_s", "loop_correction", "cost_reference",
               "memory", "analytic_memory", "collectives", "roofline", "ok"}
SKIP_KEYS = {"cell", "arch", "shape", "ok", "skipped"}


@pytest.mark.parametrize("arch", ["gemma-2b", "olmoe-1b-7b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_cost_reference_within_ten_percent_of_the_reference(arch, shape):
    got = cost_reference(get_config(arch).reduced(),
                         dataclasses.replace(get_shape(shape), seq_len=64, global_batch=4))
    want = jcost_reference(jget_config(arch).reduced(),
                           dataclasses.replace(jget_shape(shape), seq_len=64, global_batch=4))
    assert set(got) == set(want)
    assert got["global_flops"] == pytest.approx(want["global_flops"], rel=0.1)
    assert got["global_bytes_prefusion"] > 0 and got["transcendentals"] > 0


def _cli(*argv, cwd):
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *argv], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_writes_the_reference_record(tmp_path):
    proc = _cli("--arch", "gemma-2b", "--shape", "decode_32k", "--mesh", "single",
                "--out", str(tmp_path), "--save-hlo", "--hw", "nvidia-h100-sxm", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads((tmp_path / "gemma-2b__decode_32k__single.json").read_text())
    assert RECORD_KEYS <= set(rec) and rec["ok"] and rec["chips"] == 256
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["hw"] == "nvidia-h100-sxm"
    assert rec["collectives"]["op_counts"]["all-reduce"] > 0
    assert rec["loop_correction"] >= 1.0
    calls = (tmp_path / "gemma-2b__decode_32k__single.calls.jsonl").read_text().splitlines()
    assert sum(rec["collectives"]["op_counts"].values()) == len(calls)
    assert set(json.loads(calls[0])) == {"op", "axis", "n", "payload_bytes", "wire_bytes"}


def test_cli_writes_the_skip_record_and_fails_a_failing_cell(tmp_path, monkeypatch):
    proc = _cli("--arch", "gemma-2b", "--shape", "long_500k", "--out", str(tmp_path),
                cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads((tmp_path / "gemma-2b__long_500k__skip.json").read_text())
    assert set(rec) == SKIP_KEYS and rec["ok"] and "inapplicable" in rec["skipped"]

    def broken(*a, **kw):
        raise RuntimeError("no cell")

    monkeypatch.setattr(dryrun, "build_cell", broken)
    assert dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k", "--mesh", "multi",
                        "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "whisper-base__decode_32k__multi.json").read_text())
    assert not rec["ok"] and rec["error"] == "RuntimeError: no cell"


def test_small_mesh_dryrun_cell_runs():
    """The twin of ``tests/test_dist.py::test_small_mesh_dryrun_cell_compiles``:
    the reduced olmoe train cell on the (2, 4) test mesh, dry-run at rank 0
    with costs and collectives."""
    cfg = get_config("olmoe-1b-7b").reduced().replace(vocab_size=512)
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=128, global_batch=8)
    cell = build_cell(cfg, shape, make_test_mesh())
    rec = dryrun.run_cell(cell, None, ref=cost_reference(cfg, shape))
    assert rec["collectives"]["per_device_bytes"] > 0
    assert rec["memory"]["flops_per_device"] > 0 and rec["loop_correction"] >= 1.0
    assert rec["memory"]["out_bytes"] > 0 and rec["memory"]["temp_bytes"] == 0
