"""The 95th percentile of every gap between two consecutive tokens of one
request, the later token emitted in the window (client clock), in ms."""
from perfbench.yardstick import p95


def read(records):
    w0, w1 = records["window"]
    gaps = [b - a for r in records["requests"] for a, b in zip(r["times"], r["times"][1:])
            if w0 <= b < w1]
    return 1e3 * p95(gaps) if gaps else None
