"""The program's own spans and counters, for the per-layer readers that
read them: its ``core.timing`` store of the traced span (the same stretch
the profiler recorded), the engine's ticks put on the device trace's clock,
and the sums those readers take.

The i-th ``engine.tick`` span of the store and the harness's i-th
``engine.step`` span cover the same tick (the profiler starts and stops
between ticks), so each tick's spans are shifted by the difference of the
two starts.  Where the program keeps no store (one without
``trace_store``), the store is empty, or the ticks do not pair up, a reader
gets None.
"""
from __future__ import annotations

from perfbench import yardstick

#: the engine's spans in which the host launches a step's kernels
ENQUEUE = ("engine.decode.enqueue", "engine.prefill.enqueue")
#: the engine's spans in which the host launches, or waits for the device
LAUNCH_OR_WAIT = ENQUEUE + ("engine.decode.wait", "engine.prefill.read")


def store():
    """The program's store of the traced span, or None."""
    try:
        from repro_torch.core import timing
    except ImportError:
        return None
    read = getattr(timing, "trace_store", None)
    if read is None:
        return None
    found = read()
    return found if found["spans"] or found["counters"] else None


def counter_share(part: str, whole: str):
    """Percent: the counter ``part`` over the counter ``whole``."""
    found = store()
    if found is None or not found["counters"].get(whole):
        return None
    return 100.0 * found["counters"].get(part, 0) / found["counters"][whole]


def device_share(records: dict, keep):
    """Percent: the device time of the spans whose name ``keep`` accepts
    over the traced span's busy time."""
    found = store()
    busy = (records.get("trace") or {}).get("busy_s")
    if found is None or not busy:
        return None
    times = [s["device_s"] for s in found["spans"]
             if keep(s["name"]) and s["device_s"] is not None]
    return 100.0 * sum(times) / busy if times else None


def ticks(records: dict):
    """Each engine tick's engine spans as (name, start, end) on the device
    trace's clock, or None."""
    found = store()
    steps = sorted(a for name, a, _ in (records.get("trace") or {}).get("spans", [])
                   if name == "engine.step")
    if found is None:
        return None
    mine = [s for s in found["spans"] if s["name"] == "engine.tick"]
    if not mine or len(mine) != len(steps):
        return None
    by_tag: dict = {}
    for s in found["spans"]:
        if s["name"].startswith("engine."):
            by_tag.setdefault(s["tag"], []).append(s)
    out = []
    for tick, start in zip(mine, steps):
        shift = start - tick["start_s"]
        out.append([(s["name"], s["start_s"] + shift, s["end_s"] + shift)
                    for s in by_tag[tick["tag"]]])
    return out


def union(intervals) -> list:
    """The [start, end) intervals merged into disjoint ones, in order."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap(xs: list, ys: list) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_within(records: dict, inside: tuple, outside: tuple = ()):
    """Percent of the traced span in which no kernel runs while the host is
    in an engine span named in ``inside`` and in none named in ``outside``
    (spans that lie within those of ``inside``).  The idle gaps are the
    device trace's, as the harness takes them: from its first kernel to its
    last."""
    trace = records.get("trace") or {}
    events, window = trace.get("device_events"), trace.get("window_s")
    spans = ticks(records)
    if not events or not window or spans is None:
        return None
    intervals = [(a, b) for _, a, b in events]
    gaps = yardstick.idle_gaps(intervals, min(a for a, _ in intervals),
                               max(b for _, b in intervals))
    within = union((a, b) for tick in spans for name, a, b in tick if name in inside)
    left_out = union((a, b) for tick in spans for name, a, b in tick if name in outside)
    return 100.0 * (overlap(gaps, within) - overlap(gaps, left_out)) / window
