"""The port's measure→model loop end to end on the CPU, with no stubs: every
probe runs its plain PyTorch path, the model is fitted and registered, and
the report serializes on schema v1."""
import json
import math

import repro_torch.hw as thw
from repro_torch.core.dissect import dissect_measure


def test_dissect_measure_cpu_end_to_end(tmp_path):
    out = tmp_path / "report.json"
    try:
        rep = dissect_measure(quick=True, out_path=str(out), device="cpu")
        assert rep.mode == "measure" and rep.device == "cpu"
        pc = rep.probe_results["pointer_chase"]
        assert pc["x"] == [1 << p for p in range(12, 25)] and pc["unit"] == "ns/load"
        assert rep.probe_results["matmul_throughput"]["x"] == ["float32:256", "float32:512"]
        assert len(rep.probe_results["op_latency"]["x"]) == 11
        for probe in ("pointer_chase", "stream_bandwidth", "matmul_throughput"):
            assert rep.probe_results[probe]["meta"]["backend"] == "torch"
            assert all(math.isfinite(y) and y > 0 for y in rep.probe_results[probe]["y"])
        assert rep.detected_levels and rep.hardware.main_memory_Bps > 0
        assert thw.get("measured-host") == rep.hardware
        assert thw.compare("measured-host", "h100")["b"] == "nvidia-h100-sxm"
        doc = json.loads(out.read_text())
        assert doc["kind"] == "dissect_report" and doc["env"]["backend"] == "cpu"
    finally:
        thw.unregister("measured-host")
