"""Tab 4.1 analogue — dependent-issue op latency table.

Port of ``repro.bench.suites.instr``, with its record names.  The paper
measures SASS instruction latencies with control-word stall tuning; here
``probe_op_latency`` times one launch of the ``op_latency`` kernel per op on
the card, a dependent chain in registers, less the move-only chain (the
launch and the loop).  On the CPU the chain runs as eager PyTorch ops, the
kernel's plain version."""
from __future__ import annotations

from repro_torch.core import probes
from repro_torch.core.registry import register

from ..schema import BenchRecord


@register(
    "instr",
    paper_ref="Tab 4.1",
    description="dependent-issue op latency",
    quick={"chain": 1024},
    full={"chain": 8192},
)
def bench_instr(chain=1024, device="cuda") -> list:
    res = probes.probe_op_latency(chain=chain, device=device)
    recs = [
        BenchRecord(
            name=f"oplat_{name}",
            benchmark="instr",
            x=name,
            value=lat,
            unit="ns/op",
            metrics={"us_per_call": lat * 1e-3},
            info=f"dependent-issue, {res.meta['backend']} backend",
        )
        for name, lat in zip(res.x, res.y)
    ]
    recs.append(
        BenchRecord(
            name="oplat_loop_overhead",
            benchmark="instr",
            x="baseline",
            value=res.meta["base_ns"],
            unit="ns/op",
            info="move-only chain: launch and loop overhead a step "
                 "(subtracted from op rows)",
        )
    )
    return recs
