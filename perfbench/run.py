"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Exits non-zero, printing no result, where no
CUDA device (or fewer than the cell asks for) is visible, where the program
cannot be imported, or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    harness.cache_dirs(ROOT)
    import torch

    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"perfbench: {args.workload} needs {need} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"perfbench: the program is not in this checkout ({src / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device("cuda", 0),
                          t_start=T_START, torch=torch)
    result, checks = harness.execute(ctx)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    harness.report(result, checks, harness.power_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
