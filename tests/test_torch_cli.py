"""``python -m repro_torch.bench`` as a user runs it: on the CPU only when
asked, schema-v1 JSON with the reference suite's record names."""
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from repro.bench.schema import validate_result

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
FIXED = [
    "dissect_host_stream_bw",
    "dissect_host_matmul_peak",
    "dissect_host_n_levels",
    "dissect_tpu_model_hbm_bw",
    "dissect_tpu_model_bf16_peak",
]


def _bench(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.bench", *args],
        cwd=cwd, env=ENV, capture_output=True, text=True, timeout=300,
    )


def test_cli_run_dissect_cpu_writes_schema_v1(tmp_path):
    out = tmp_path / "r.json"
    proc = _bench("run", "dissect", "--device", "cpu", "--out", str(out), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.read_text())
    validate_result(doc)  # the reference's own validator: one schema for both
    names = [r["name"] for r in doc["records"]]
    n_levels = int(next(r["value"] for r in doc["records"] if r["name"] == "dissect_host_n_levels"))
    levels = [f"dissect_host_level{i}_latency" for i in range(n_levels)]
    assert names == FIXED[:3] + levels + FIXED[3:]
    assert doc["env"]["backend"] == "cpu" and doc["env"]["torch_version"] == torch.__version__
    assert not doc["errors"]


def test_cli_list_and_no_card_exit(tmp_path):
    proc = _bench("list", cwd=tmp_path)
    listed = [line.split()[0] for line in proc.stdout.splitlines()]
    assert proc.returncode == 0 and listed == sorted(listed)
    assert {"dissect", "instr", "atomics", "throttle", "bandwidth[cuda]", "memhier[torch]",
            "gemm_lp[cuda]"} <= set(listed)
    if not torch.cuda.is_available():
        proc = _bench("run", "dissect", cwd=tmp_path)
        assert proc.returncode == 2 and "device='cpu'" in proc.stderr
