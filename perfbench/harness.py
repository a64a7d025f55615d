"""The harness: finds a cell's configuration, traffic, driver, limits and
metric readers by the names in ``BENCHMARK.json``, runs the cell once, and
prints its result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by name:

- ``configs/<config>.json``: the sizes, ``source``, ``reduced``, ``assumed``,
  and ``port``: the program's ``ModelConfig`` name and field overrides;
- ``traffic/<traffic>.json``: ``driver`` and its parameters;
- ``drivers/<driver>.py``: ``setup(ctx)``, ``window(ctx, state)``,
  ``readings(ctx, state, outcome, control=False)`` and
  ``check(ctx, state, outcome, readings)``;
- ``limits/<workload>.json``: each number the check compares, its limit;
- ``metrics/<metric>.py``: ``read(records) -> float | None``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

#: top-level modules that may not be loaded in a run (whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class BenchError(RuntimeError):
    """A run that cannot give a result."""


# ---------------------------------------------------------------------------
# the spec and its files
# ---------------------------------------------------------------------------
def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not Path(path).exists():
        raise BenchError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of the spec, with everything found for it by name."""

    spec: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    root: Path

    @property
    def name(self) -> str:
        return self.workload["name"]

    def driver(self):
        return load_module(self.root / "perfbench" / "drivers" / f"{self.traffic['driver']}.py",
                           f"perfbench_driver_{self.traffic['driver']}")

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list that move one of its end-to-end metrics."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def load_cell(root: Path, workload: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "perfbench" / "limits" / f"{w['name']}.json")
    return Cell(spec, w, config, traffic, limits, root)


def read_metric(root: Path, name: str, records: dict):
    """The per-layer metric ``name`` read by its own reader, or None."""
    mod = load_module(root / "perfbench" / "metrics" / f"{name}.py", f"perfbench_metric_{name}")
    return mod.read(records)


# ---------------------------------------------------------------------------
# tracing: spans on the host, the device trace over a steady span
# ---------------------------------------------------------------------------
class Tracer:
    """Harness spans (named host ranges in the profiler's timeline) and one
    traced span of the window: :meth:`start` at a step boundary, :meth:`stop`
    at a later one.  Off unless ``enabled``; then every call is a no-op."""

    def __init__(self, torch, enabled: bool, cuda: bool = True):
        self.torch = torch
        self.enabled = enabled
        self.cuda = cuda
        self.prof = None
        self.t0 = self.t1 = None
        self.done = False

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function("perfbench." + name)

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def start(self) -> None:
        if not self.enabled or self.done or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.active:
            return
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.done = True

    def records(self) -> dict:
        """The traced span: its length, the device's kernel intervals (s,
        relative), the harness spans, and the idle gaps labelled by span."""
        if self.prof is None:
            return {}
        from perfbench import yardstick

        torch = self.torch
        events = self.prof.events()
        dev, host = [], []
        for e in events:
            a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.name.startswith("perfbench."):
                # a harness span: on the host's timeline, and mirrored on the
                # device's as an annotation, which is no work of the device
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    host.append((e.name[len("perfbench."):], a, b))
            elif e.device_type == torch.autograd.DeviceType.CUDA or (
                    not self.cuda and e.name.startswith("aten::")):
                dev.append((e.name, a, b))
        window_s = self.t1 - self.t0
        self.prof = None
        if not dev:
            return {"window_s": window_s, "device_events": [], "busy_s": 0.0, "spans": host}
        intervals = [(a, b) for _, a, b in dev]
        lo = min(a for a, _ in intervals)
        busy = yardstick.busy_seconds(intervals)
        by_name: dict = {}
        for name, a, b in dev:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        gaps = []
        for a, b in yardstick.idle_gaps(intervals, lo, max(b for _, b in intervals)):
            inside = [(n, s, e) for n, s, e in host if s <= a < e]
            label = min(inside, key=lambda t: t[2] - t[1])[0] if inside else "outside spans"
            gaps.append((label, b - a))
        return {"window_s": window_s, "device_events": dev, "busy_s": busy, "spans": host,
                "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
                "idle_gaps": sorted(gaps, key=lambda kv: -kv[1])}


# ---------------------------------------------------------------------------
# one run's context
# ---------------------------------------------------------------------------
@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    torch: object = None
    tracer: Tracer = None
    t_window: float = None
    overrides: dict = field(default_factory=dict)
    readings: dict = None

    @property
    def traffic(self) -> dict:
        return {**self.cell.traffic, **self.overrides.get("traffic", {})}

    @property
    def model(self) -> dict:
        """The configuration file's sizes (what the references and the
        yardstick read)."""
        return {**self.cell.config["model"], **self.overrides.get("model", {})}

    def port_config(self):
        """The program's ``ModelConfig`` for this cell: its name with the
        file's overrides, checked against every size the file states."""
        from repro_torch.configs import get_config

        port = self.cell.config["port"]
        cfg = get_config(port["config"])
        if self.overrides.get("reduced"):
            cfg = cfg.reduced()
        cfg = cfg.replace(**port.get("overrides", {}))
        if self.overrides.get("port"):
            cfg = cfg.replace(**self.overrides["port"])
        for key, value in self.model.items():
            if hasattr(cfg, key) and getattr(cfg, key) != value:
                raise BenchError(f"the program's {port['config']} has {key}="
                                 f"{getattr(cfg, key)!r}, the configuration file {value!r}")
        return cfg

    def mark(self, what: str) -> None:
        """A line on stderr: how far into the run ``what`` was reached."""
        print(f"perfbench: {what} at {time.perf_counter() - self.t_start:.3f} s",
              file=sys.stderr, flush=True)

    def window_start(self) -> float:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        self.t_window = time.perf_counter()
        self.mark("window opens")
        return self.t_window

    @property
    def setup_s(self) -> float:
        return self.t_window - self.t_start


@dataclass
class Outcome:
    """What a window produced: counts, end-to-end values, the records the
    per-layer readers take, and whatever the check needs of the program's
    answers."""

    attempted: int
    failed: int
    end_to_end: dict
    records: dict
    answers: object = None


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------
def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def execute(ctx: Context, control: bool = False) -> tuple:
    """Run the cell: set-up, window, the check.  Returns (result dict, the
    checks [(name, value, limit)]); the readings are left in
    ``ctx.readings``.  With ``control`` the check judges the float8
    control's readings in the program's place (the cell's limits have to
    call it not correct)."""
    torch = ctx.torch
    cell = ctx.cell
    driver = cell.driver()
    ctx.tracer = Tracer(torch, ctx.trace, ctx.device.type == "cuda")
    state = driver.setup(ctx)
    outcome = driver.window(ctx, state)
    memory_peak = (torch.cuda.max_memory_allocated(ctx.device)
                   if ctx.device.type == "cuda" else 0)
    trace = ctx.tracer.records() if ctx.trace else {}
    records = {**outcome.records, "trace": trace, "model": ctx.model}
    ctx.readings = driver.readings(ctx, state, outcome, control=control)
    ctx.mark(f"readings {ctx.readings}")
    judged = ctx.readings
    if control:  # the control's reading of each number; none where it gave none
        judged = {k: ctx.readings.get("control." + k, math.inf)
                  for k in ctx.readings if not k.startswith("control.")}
    checks = driver.check(ctx, state, outcome, judged)
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in checks)

    metrics = {}
    if ctx.trace:
        for m in cell.per_layer():
            value = read_metric(cell.root, m["name"], records)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            value = ctx.setup_s if m["name"] == "setup_s" else outcome.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                       else "cpu"),
              "count": cell.workload["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics, "device": device}
    if ctx.trace:
        device["busy_s"] = float(trace.get("busy_s", 0.0))
        device["window_s"] = float(trace.get("window_s", 0.0))
        if trace.get("device_ops") is not None:
            result["breakdown"] = {
                "device_ops": [[n[:200], float(s)] for n, s in trace["device_ops"][:10]],
                "idle_gaps": [[n, float(s)] for n, s in trace["idle_gaps"][:10]]}
    result["checks"] = {name: {"value": _finite(v), "limit": float(limit)}
                        for name, v, limit in checks}
    return result, checks


def _finite(x: float) -> float:
    """``x`` as JSON can carry it: a reading with no answer behind it (inf
    or nan) as 1e300, which fails every limit."""
    return float(x) if math.isfinite(x) else 1e300


def report(result: dict, checks: list, power: str) -> None:
    """The compared numbers as the last lines of stderr, then the result as
    the last line of stdout."""
    print(f"card power limit: {power}", file=sys.stderr)
    for name, value, limit in checks:
        verdict = "ok" if math.isfinite(value) and value <= limit else "FAIL"
        print(f"check {name}: {value!r} limit {limit!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
