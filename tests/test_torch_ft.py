"""The port's fault-tolerance monitors against the reference's on the CPU.

``repro_torch.ft.HeartbeatMonitor`` and ``StragglerDetector`` are fed the
same synthetic beats and step times as ``repro.ft``'s (as
``tests/test_ckpt_ft.py`` feeds the reference): dead/alive workers, the
fleet median, the flagged stragglers with their inflations and the thermal
verdicts must be equal, as must the throttle signature behind the cluster's
``HealthConfig`` threshold.
"""
import numpy as np
import pytest

from repro import ft as jft
from repro.core import throttle as jthrottle
from repro.serve import HealthConfig as JHealthConfig
from repro_torch import ft as tft
from repro_torch.core import throttle as tthrottle
from repro_torch.serve import HealthConfig as THealthConfig


def _heartbeat_trace(ft):
    t = [0.0]
    mon = ft.HeartbeatMonitor(timeout_s=10.0, clock=lambda: t[0])
    out = [mon.min_step(), mon.dead_workers()]
    mon.beat("w0", 1)
    mon.beat("w1", 1)
    t[0] = 5.0
    mon.beat("w0", 2)
    t[0] = 12.0
    out += [mon.dead_workers(), mon.alive_workers(), mon.min_step()]
    mon.forget("w1")
    mon.beat("w2", 3)
    t[0] = 16.0
    out += [mon.dead_workers(), mon.alive_workers(), mon.min_step()]
    return out


def test_heartbeat_detects_dead_worker_as_the_reference():
    got, want = _heartbeat_trace(tft), _heartbeat_trace(jft)
    assert got == want
    assert got[2] == ["w1"] and got[3] == ["w0"] and got[4] == 1
    assert got[5] == ["w0"] and got[6] == ["w2"]  # w1 forgotten, w0 aged out


def _straggler_trace(ft, series: dict, **kw):
    det = ft.StragglerDetector(**kw)
    n = max(len(v) for v in series.values())
    seen = []
    for i in range(n):
        for w, times in series.items():
            if i < len(times):
                det.observe(w, times[i])
        seen.append(det.stragglers())
    thermal = {w: det.likely_thermal(w) for w in series}
    return det.signature(), det.fleet_median(), seen, thermal


def _series(kind: str) -> dict:
    rng = np.random.default_rng(3)
    base = {f"w{i}": list(1.0 + 0.02 * rng.standard_normal(12)) for i in range(4)}
    sig = tthrottle.slowdown_factor(tthrottle.V5E_THROTTLE, 0.9)
    if kind == "throttled":
        base["slow"] = [sig] * 12
    elif kind == "late":  # healthy for two steps, then fully throttled
        base["slow"] = [1.0] * 2 + [sig] * 10
    elif kind == "network":  # inflated past the thermal signature
        base["slow"] = [2.5] * 12
    elif kind == "pair":  # two workers: the median sits between them
        base = {"a": [1.0] * 8, "b": [1.0] * 3 + [4.0] * 5}
    return base


@pytest.mark.parametrize("kind", ["healthy", "throttled", "late", "network", "pair"])
@pytest.mark.parametrize("kw", [{}, {"margin": 0.25, "min_samples": 3}, {"ewma_alpha": 0.5}])
def test_straggler_detector_matches_the_reference(kind, kw):
    series = _series(kind)
    got = _straggler_trace(tft, series, **kw)
    want = _straggler_trace(jft, series, **kw)
    assert got[0] == want[0] and got[1] == pytest.approx(want[1], rel=1e-12)
    assert [[w for w, _ in s] for s in got[2]] == [[w for w, _ in s] for s in want[2]]
    for gs, ws in zip(got[2], want[2]):
        assert [i for _, i in gs] == pytest.approx([i for _, i in ws], rel=1e-12)
    assert got[3] == want[3]
    flagged = {w for w, _ in got[2][-1]}
    if kind == "healthy":
        assert not flagged
    if kind in ("throttled", "late", "network"):
        assert flagged == {"slow"}
    if kind == "throttled":
        assert got[3]["slow"]
    if kind == "network":
        assert not got[3]["slow"]  # beyond 1.3x the thermal signature


def test_forget_drops_a_workers_history():
    for ft in (tft, jft):
        det = ft.StragglerDetector(min_samples=2)
        for _ in range(4):
            det.observe("a", 1.0)
            det.observe("b", 3.0)
            det.observe("c", 1.0)
        assert [w for w, _ in det.stragglers()] == ["b"]
        det.forget("b")
        assert det.stragglers() == [] and det.fleet_median() == 1.0


@pytest.mark.parametrize("util", [0.3, 0.6, 0.9, 1.0])
@pytest.mark.parametrize("part", ["T4_THROTTLE", "V5E_THROTTLE"])
def test_slowdown_signature_and_health_threshold(part, util):
    got = tthrottle.slowdown_factor(getattr(tthrottle, part), util)
    want = jthrottle.slowdown_factor(getattr(jthrottle, part), util)
    assert got == pytest.approx(want, rel=1e-12) and 1.0 <= got < 3.0
    th, jh = THealthConfig(), JHealthConfig()
    assert (th.utilization, th.margin, th.min_samples, th.heartbeat_timeout, th.cooldown,
            th.probe_ticks, th.warmup_ticks) == (jh.utilization, jh.margin, jh.min_samples,
                                                 jh.heartbeat_timeout, jh.cooldown,
                                                 jh.probe_ticks, jh.warmup_ticks)
    det = tft.StragglerDetector(throttle=th.throttle, utilization=th.utilization,
                                margin=th.margin)
    sig = det.signature()
    # the cluster's flag threshold at the defaults: 1 + (sig - 1)(1 - margin)
    assert 1.0 + (sig - 1.0) * (1.0 - th.margin) == pytest.approx(1.1215, abs=5e-4)
