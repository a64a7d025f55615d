"""Perf-over-time: fold per-commit bench artifacts into one trend report.

Port of ``repro.bench.trend``.

CI's bench job stamps every run's results file as ``BENCH_<sha>.json`` (the
first 12 hex digits of the commit); tagged jobs add an uppercase infix, e.g.
the chaos job's ``BENCH_CHAOS_<sha>.json``.  This module aggregates a
directory (or explicit list) of those artifacts into one series per record
name — same-sha files merge into one commit point (first file primary,
duplicate record names deduplicated) ordered by each run's ``created_at``
stamp — and renders the trajectory as markdown
(for humans: first/last value, percent delta, direction-aware regression
flag) or JSON (for plotting).  ``python -m repro_torch.bench trend`` is the CLI:

    python -m repro_torch.bench trend artifacts/ --out trend.md
    python -m repro_torch.bench trend artifacts/ --json --benchmark gemm

Only rows gated by direction (``better`` = lower/higher) get a regression
flag; ``info`` rows are carried for plotting but never flagged — the same
semantics as the ``compare`` gate.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

from .schema import BenchResult, SchemaError

#: ``BENCH_<sha>.json`` plus tagged variants like ``BENCH_CHAOS_<sha>.json``
_BENCH_FILE = re.compile(
    r"BENCH_(?:(?P<tag>[A-Z][A-Z0-9]*)_)?(?P<sha>[0-9a-fA-F]{4,40})\.json$"
)

#: relative change that earns a direction-aware flag in the markdown view
FLAG_THRESHOLD = 0.10


def discover(paths) -> list:
    """Expand directories to their ``BENCH_*.json`` members; keep files."""
    out = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.glob("BENCH_*.json")))
        else:
            out.append(p)
    return out


def load_commits(files) -> list:
    """``[(sha, BenchResult)]`` ordered by run timestamp (then sha).

    The sha comes from the ``BENCH_<sha>.json`` / ``BENCH_<TAG>_<sha>.json``
    filename; a file named otherwise keeps its stem, so ad-hoc results can
    join a trend.  Multiple files for one sha (the main bench artifact plus
    tagged job artifacts like ``BENCH_CHAOS_<sha>.json``) merge into a
    single commit entry: the first file is primary and later files
    contribute only record names it does not already carry (jobs overlap on
    shared quick suites).  Files that fail schema validation raise — a
    trend over silently-dropped commits would misreport where a regression
    landed.
    """
    commits = []
    by_sha: dict = {}
    for f in files:
        f = Path(f)
        try:
            result = BenchResult.load(f)
        except SchemaError as e:
            raise SchemaError(f"{f}: {e}") from None
        m = _BENCH_FILE.search(f.name)
        sha = m.group("sha") if m else f.stem
        primary = by_sha.get(sha)
        if primary is None:
            by_sha[sha] = result
            commits.append((sha, result))
        else:
            seen = {r.name for r in primary.records}
            primary.records.extend(
                r for r in result.records if r.name not in seen
            )
    commits.sort(key=lambda c: (c[1].created_at, c[0]))
    return commits


def build_trend(commits, benchmarks=None) -> dict:
    """One series per record name over the commit axis.

    ``benchmarks`` filters by benchmark/record-name prefix (the same
    prefix semantics as ``bench run``).  Records absent from some commits
    simply have fewer points — renames show up as one series ending and
    another starting, which is the honest view.
    """
    prefixes = tuple(benchmarks or ())

    def keep(r) -> bool:
        if not prefixes:
            return True
        return any(r.benchmark.startswith(p) or r.name.startswith(p)
                   for p in prefixes)

    series: dict = {}
    for sha, result in commits:
        for r in result.records:
            if not keep(r):
                continue
            s = series.setdefault(r.name, {
                "name": r.name,
                "benchmark": r.benchmark,
                "unit": r.unit,
                "better": r.better,
                "points": [],
            })
            s["points"].append({
                "sha": sha,
                "created_at": result.created_at,
                "value": r.value,
            })
    return {
        "commits": [
            {"sha": sha, "created_at": res.created_at, "mode": res.mode}
            for sha, res in commits
        ],
        "series": [series[k] for k in sorted(series)],
    }


def _delta_pct(points) -> float:
    first, last = points[0]["value"], points[-1]["value"]
    if first == 0:
        return float("inf") if last else 0.0
    return (last - first) / abs(first) * 100.0


def _flag(better: str, delta_pct: float) -> str:
    if better not in ("lower", "higher") or abs(delta_pct) < FLAG_THRESHOLD * 100:
        return ""
    worse = delta_pct > 0 if better == "lower" else delta_pct < 0
    return "regressed" if worse else "improved"


def format_markdown(trend: dict) -> str:
    """Render a trend dict (from :func:`build_trend`) as a markdown report."""
    commits = trend["commits"]
    lines = ["# Bench trend", ""]
    if not commits:
        lines.append("No commits found.")
        return "\n".join(lines) + "\n"
    first, last = commits[0], commits[-1]
    lines.append(
        f"{len(commits)} commit(s): `{first['sha']}` ({first['created_at']}) "
        f"→ `{last['sha']}` ({last['created_at']})"
    )
    lines += [
        "",
        "| record | unit | better | n | first | last | Δ% | flag |",
        "|---|---|---|---:|---:|---:|---:|---|",
    ]
    for s in trend["series"]:
        pts = s["points"]
        d = _delta_pct(pts)
        lines.append(
            f"| {s['name']} | {s['unit']} | {s['better']} | {len(pts)} "
            f"| {pts[0]['value']:.4g} | {pts[-1]['value']:.4g} "
            f"| {d:+.1f} | {_flag(s['better'], d)} |"
        )
    flagged = [s["name"] for s in trend["series"]
               if _flag(s["better"], _delta_pct(s["points"])) == "regressed"]
    lines.append("")
    if flagged:
        lines.append(
            f"**{len(flagged)} record(s) regressed ≥"
            f"{FLAG_THRESHOLD:.0%} first→last:** "
            + ", ".join(f"`{n}`" for n in flagged)
        )
    else:
        lines.append(
            f"No gated record regressed ≥{FLAG_THRESHOLD:.0%} first→last."
        )
    return "\n".join(lines) + "\n"


def format_json(trend: dict) -> str:
    return json.dumps(trend, indent=2)
