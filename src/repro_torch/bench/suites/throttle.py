"""Fig 4.3 / 4.4 / 4.5 analogue — clock throttling under sustained load.

Port of ``repro.bench.suites.throttle``: the fitted power/thermal governor
model (``repro_torch.core.throttle``) for the paper's T4 parameterization
(brief full clock -> power-limit plateau -> thermal step at 85 C) and for
the reference's TPU v5e envelope.  Every row is a model output, equal to the
reference's, and none is a measurement of the card; the baseline gate holds
them to the tight modeled threshold.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.registry import register
from repro_torch.core.throttle import T4_THROTTLE, V5E_THROTTLE, simulate, steady_state_clock

from ..schema import BenchRecord, finite


@register(
    "throttle",
    paper_ref="Fig 4.3-4.5",
    description="power/thermal clock governor",
    quick={"duration_s": 300, "dt": 0.5, "utils": (0.6, 0.8, 1.0)},
    full={"duration_s": 900, "dt": 0.25, "utils": (0.5, 0.6, 0.7, 0.8, 0.9, 1.0)},
)
def bench_throttle(duration_s=300, dt=0.5, utils=(0.6, 0.8, 1.0)) -> list:
    recs = []
    for name, p in (("t4", T4_THROTTLE), ("v5e", V5E_THROTTLE)):
        out = simulate(p, utilization=1.0, duration_s=duration_s, dt=dt)
        clock, temp, power = out["clock_hz"], out["temp_c"], out["power_w"]
        idx = np.argmax(clock < 0.95 * p.f_max_hz)
        t_derate = out["t"][idx] if clock.min() < 0.95 * p.f_max_hz else float("inf")
        recs += [
            BenchRecord(
                name=f"throttle_{name}_time_to_derate",
                benchmark="throttle",
                x=name,
                value=finite(t_derate, duration_s),
                unit="s",
                better="higher",  # longer at full clock is better
                measured=False,
                info=f"time to first 5% derate (capped at {duration_s}s)",
            ),
            BenchRecord(
                name=f"throttle_{name}_steady_clock",
                benchmark="throttle",
                x=name,
                value=clock[-1] / 1e6,
                unit="MHz",
                measured=False,
                info=f"steady-state clock (max {p.f_max_hz / 1e6:.0f} MHz)",
            ),
            BenchRecord(
                name=f"throttle_{name}_steady_power",
                benchmark="throttle",
                x=name,
                value=float(power[-40:].mean()),
                unit="W",
                better="info",
                measured=False,
                info=f"steady-state power (limit {p.power_limit_w:.0f} W)",
            ),
            BenchRecord(
                name=f"throttle_{name}_max_temp",
                benchmark="throttle",
                x=name,
                value=float(temp.max()),
                unit="C",
                better="info",
                measured=False,
                info=f"peak temperature (cap {p.max_temp_c:.0f} C)",
            ),
        ]
        for u in utils:
            recs.append(
                BenchRecord(
                    name=f"throttle_{name}_clock_u{int(u * 100)}",
                    benchmark="throttle",
                    x=u,
                    value=steady_state_clock(p, u) / 1e6,
                    unit="MHz",
                    measured=False,
                    info=f"sustained clock at {u:.0%} utilization",
                )
            )
    return recs
