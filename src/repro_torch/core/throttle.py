"""Clock-throttling model (paper §4.5, Figs 4.3–4.5).

The paper characterizes two mechanisms on the 70 W T4:
  - power-limit throttling: instantaneous power > limit -> proportional clock
    reduction (gradual derate as utilization/matrix size grows, Fig 4.3);
  - thermal throttling: at max operating temperature (85 C) an additional,
    much steeper step-down (Fig 4.4).

We fit that behavior as a first-order thermal RC model + a power-governor
loop.  The default parameterization reproduces the paper's qualitative
curves (validated in tests/benchmarks): full clock for only the first few
seconds, power-limited plateau, thermal step once T reaches max_temp.

A copy of ``repro.core.throttle`` (numpy only), with the reference's two
parameterizations as they are: the paper's T4 and the TPU v5e envelope.
Neither is an H100 model; the ``throttle`` suite reports their outputs as
modeled rows.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ThrottleParams:
    f_max_hz: float
    power_limit_w: float
    max_temp_c: float
    ambient_c: float = 30.0
    idle_power_w: float = 20.0
    # dynamic power ~ c * f * u   (activity-proportional, fixed voltage band)
    watts_per_hz: float = 50.0 / 1.59e9
    # first-order thermal model: C dT/dt = P - (T - T_amb)/R
    thermal_r: float = 0.9  # C per W
    thermal_c: float = 120.0  # J per C
    thermal_derate: float = 0.82  # extra clock factor once at max temp
    governor_gain: float = 0.25  # fraction of clock error corrected per step


T4_THROTTLE = ThrottleParams(
    f_max_hz=1.59e9,
    power_limit_w=70.0,
    max_temp_c=85.0,
    idle_power_w=20.0,
    # full-MXU... full-CUDA-load power slightly exceeds the 70 W cap, so the
    # governor derates within seconds (paper: "only able to run at their
    # highest supported clock frequency for a few seconds", Fig 4.5)
    watts_per_hz=58.0 / 1.59e9,
    thermal_c=60.0,
)

V5E_THROTTLE = ThrottleParams(
    f_max_hz=1.70e9,
    power_limit_w=170.0,
    max_temp_c=87.0,
    idle_power_w=60.0,
    # sustained full-MXU load modestly exceeds the 170 W envelope -> the
    # same power-then-thermal derate shape the paper measured on the T4
    watts_per_hz=135.0 / 1.70e9,
    thermal_r=0.35,
    thermal_c=260.0,
)


@dataclass
class ThrottleState:
    clock_hz: float
    temp_c: float
    power_w: float


def power(p: ThrottleParams, clock_hz: float, utilization: float) -> float:
    return p.idle_power_w + p.watts_per_hz * clock_hz * utilization


def step(p: ThrottleParams, s: ThrottleState, utilization: float, dt: float) -> ThrottleState:
    """Advance the governor + thermal model by ``dt`` seconds."""
    pw = power(p, s.clock_hz, utilization)
    # thermal integration
    temp = s.temp_c + dt * (pw - (s.temp_c - p.ambient_c) / p.thermal_r) / p.thermal_c
    # power governor: move clock toward the highest value satisfying the cap
    if utilization > 0:
        f_power = (p.power_limit_w - p.idle_power_w) / (p.watts_per_hz * utilization)
    else:
        f_power = p.f_max_hz
    f_target = min(p.f_max_hz, f_power)
    if temp >= p.max_temp_c:  # thermal throttling: steeper step-down (Fig 4.4)
        f_target = min(f_target, p.thermal_derate * f_power)
    clock = s.clock_hz + p.governor_gain * (f_target - s.clock_hz)
    clock = float(np.clip(clock, 0.1 * p.f_max_hz, p.f_max_hz))
    return ThrottleState(clock_hz=clock, temp_c=float(temp), power_w=float(pw))


def simulate(
    p: ThrottleParams, utilization: float, duration_s: float, dt: float = 0.5
) -> dict:
    """Run the model; returns arrays t/clock/temp/power (Fig 4.3/4.4 traces)."""
    s = ThrottleState(clock_hz=p.f_max_hz, temp_c=p.ambient_c, power_w=p.idle_power_w)
    n = int(duration_s / dt)
    t = np.arange(n) * dt
    clock = np.empty(n)
    temp = np.empty(n)
    pw = np.empty(n)
    for i in range(n):
        clock[i], temp[i], pw[i] = s.clock_hz, s.temp_c, s.power_w
        s = step(p, s, utilization, dt)
    return {"t": t, "clock_hz": clock, "temp_c": temp, "power_w": pw}


def steady_state_clock(p: ThrottleParams, utilization: float) -> float:
    """Long-run clock under sustained utilization (straggler detector input)."""
    out = simulate(p, utilization, duration_s=600.0, dt=1.0)
    return float(out["clock_hz"][-1])


def slowdown_factor(p: ThrottleParams, utilization: float) -> float:
    """Expected step-time inflation of a fully-throttled chip vs. nominal."""
    return p.f_max_hz / max(steady_state_clock(p, utilization), 1.0)
