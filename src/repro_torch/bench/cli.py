"""``python -m repro_torch.bench`` — run | list | compare | baseline | trend.

    run       execute registered benchmarks, write schema-versioned JSON
    list      show registered benchmarks with paper refs and sweep grids
    compare   gate a results file against the checked-in baselines
    baseline  (re)generate baseline files from a results file
    trend     aggregate per-commit BENCH_<sha>.json artifacts into a
              perf-over-time report (markdown or JSON)

``run`` measures on the card unless ``--device cpu`` is given; with no card
visible it exits 2 instead of measuring the host.  Exit codes: ``run`` is
non-zero if any benchmark errored, or — under ``--guard`` — if the numerics
guard saw any drift, saturation or native fault on what should be a clean run;
``compare`` is non-zero if the gate fails (unless ``--warn-only``);
``trend`` is non-zero only on input errors (it reports, it does not gate); a
malformed or missing input file exits 2.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.core import registry
from repro_torch.core.timing import NoCudaDeviceError

from . import baseline as bl
from . import runner
from . import trend as trend_mod
from .schema import BenchResult, SchemaError


def _cmd_list(args) -> int:
    runner.load_suites()
    specs = registry.specs()
    if args.json:
        print(
            json.dumps(
                [
                    {
                        "name": s.name,
                        "backend": s.backend,
                        "paper_ref": s.paper_ref,
                        "description": s.description,
                        "quick": s.quick,
                        "full": s.full,
                    }
                    for s in specs
                ],
                indent=2,
                default=str,
            )
        )
        return 0
    w = max((len(s.name) for s in specs), default=4)
    bw = max((len(s.backend) for s in specs), default=0)
    for s in specs:
        tag = f"{s.backend:<{bw}}  " if bw else ""
        print(f"{s.name:<{w}}  {tag}{s.paper_ref:<24}  {s.description}")
    return 0


def _cmd_run(args) -> int:
    mode = args.mode or ("full" if args.full else "quick")
    only = list(args.benchmarks or []) + list(args.only or [])
    if only and not runner.select(only):
        print(
            f"error: {' '.join(only)} matches no registered benchmark "
            f"(have: {', '.join(runner.select())})",
            file=sys.stderr,
        )
        return 2
    result = runner.run_benchmarks(
        only=only or None, mode=mode, out_path=args.out, verbose=args.verbose,
        device=args.device, guard=args.guard,
    )
    if args.csv:
        print("name,value,unit,derived")
        for r in result.records:
            print(f"{r.name},{r.value:.4f},{r.unit},{r.info.replace(',', ';')}")
    elif not args.out:
        print(result.to_json())
    else:
        print(
            f"wrote {args.out}: {len(result.records)} records from "
            f"{len(result.benchmarks())} benchmarks, {len(result.errors)} errors"
        )
    for name, err in sorted(result.errors.items()):
        print(f"ERROR {name}: {err}", file=sys.stderr)
    if args.guard:
        from repro_torch.kernels import guard as kguard

        m = kguard.metrics()
        print(
            f"guard[{args.guard}]: {m.checks} checks, {m.drift_events} drift, "
            f"{m.saturation_events} saturation, {m.faults} faults, "
            f"quarantined={sorted(m.quarantined_ops) or '[]'}",
            file=sys.stderr,
        )
        if m.drift_events or m.saturation_events:
            print(
                "guard: drift/saturation detected on a clean run — failing",
                file=sys.stderr,
            )
            return 1
        if m.faults:
            print("guard: a kernel op faulted on a clean run — failing", file=sys.stderr)
            return 1
    return 1 if result.errors else 0


def _cmd_compare(args) -> int:
    report = bl.compare_files(
        args.results, args.baselines, threshold_scale=args.threshold_scale
    )
    if args.json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(report.format())
    if args.warn_only:
        return 0
    return 0 if report.passed else 1


def _cmd_baseline(args) -> int:
    result = BenchResult.load(args.results)
    paths = bl.write_baselines(result, args.out_dir)
    for p in paths:
        print(f"wrote {p}")
    return 0


def _cmd_trend(args) -> int:
    files = trend_mod.discover(args.paths)
    if not files:
        print(
            f"error: no BENCH_*.json files under {' '.join(args.paths)}",
            file=sys.stderr,
        )
        return 2
    commits = trend_mod.load_commits(files)
    report = trend_mod.build_trend(commits, benchmarks=args.benchmark)
    rendered = (
        trend_mod.format_json(report) if args.json
        else trend_mod.format_markdown(report)
    )
    if args.out:
        Path(args.out).write_text(
            rendered if rendered.endswith("\n") else rendered + "\n"
        )
        print(
            f"wrote {args.out}: {len(report['series'])} series over "
            f"{len(report['commits'])} commit(s)"
        )
    else:
        print(rendered, end="" if rendered.endswith("\n") else "\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="show registered benchmarks")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_list)

    p = sub.add_parser("run", help="execute benchmarks, emit JSON results")
    p.add_argument(
        "benchmarks", nargs="*",
        help="benchmark name prefixes to run (prefixes sweep up [backend] variants)",
    )
    g = p.add_mutually_exclusive_group()
    g.add_argument("--quick", action="store_true", help="quick grids (default)")
    g.add_argument("--full", action="store_true", help="full paper-scale grids")
    g.add_argument("--mode", choices=("quick", "full"), help="alias for --quick/--full")
    p.add_argument("--only", nargs="*", help="benchmark name prefixes to run (legacy alias)")
    p.add_argument("--out", help="write JSON results to this path")
    p.add_argument("--csv", action="store_true", help="print legacy CSV to stdout")
    p.add_argument(
        "--device", default="cuda",
        help="device to measure: cuda (default; fails with no card visible) or cpu",
    )
    p.add_argument(
        "--guard", choices=("sample", "shadow"),
        help="run under the numerics guard; exit 1 on any drift, saturation "
             "or native fault (clean-run gate)",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("compare", help="gate results against baselines")
    p.add_argument("results", help="results JSON from `run --out`")
    p.add_argument("baselines", help="baseline directory (benchmarks/baselines_torch/)")
    p.add_argument("--threshold-scale", type=float, default=1.0)
    p.add_argument("--warn-only", action="store_true", help="report but exit 0")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_compare)

    p = sub.add_parser("baseline", help="write baseline files from results")
    p.add_argument("results")
    p.add_argument("--out-dir", default="benchmarks/baselines_torch")
    p.set_defaults(fn=_cmd_baseline)

    p = sub.add_parser(
        "trend", help="aggregate per-commit BENCH_<sha>.json into a report"
    )
    p.add_argument(
        "paths", nargs="+",
        help="directories (scanned for BENCH_*.json) and/or result files",
    )
    p.add_argument(
        "--benchmark", nargs="*",
        help="benchmark/record-name prefixes to include (default: all)",
    )
    p.add_argument("--json", action="store_true", help="emit JSON instead of markdown")
    p.add_argument("--out", help="write the report to this path")
    p.set_defaults(fn=_cmd_trend)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (SchemaError, FileNotFoundError, NoCudaDeviceError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
