"""``python -m repro_torch.bench`` — run | list.

    run       execute registered benchmarks, write schema-versioned JSON
    list      show registered benchmarks with paper refs and sweep grids

``run`` measures on the card unless ``--device cpu`` is given; with no card
visible it exits 2 instead of measuring the host.  It is non-zero if any
benchmark errored.  ``compare``, ``baseline`` and ``trend`` of
``repro.bench`` are still to be ported.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core import registry
from repro_torch.core.timing import NoCudaDeviceError

from . import runner
from .schema import SchemaError


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
        device=args.device,
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
    return 1 if result.errors else 0


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
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=_cmd_run)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (SchemaError, FileNotFoundError, NoCudaDeviceError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
