"""Spread of the plain pointer chase's time on one CUDA card, by the size of
the CUDA graph that ``kernels.pchase.pchase_torch`` replays.

    python tools/pchase_plain_spread.py

The plain walk is one ``index_select`` a step; on the card it runs as
replays of a graph of ``GRAPH_STEPS`` steps, captured on the first call for
a permutation.  Too few steps a graph and the host's replay launches pace
the walk.  For each graph size this times the ``memhier[torch]`` point
(2^12 steps, ``time_fn``'s minimum of 5) twelve times and prints the least,
median and largest ns per load, so the size whose readings spread least can
be chosen: the gate holds these rows to the reference's 75 %.
"""
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.pchase import single_cycle_successors  # noqa: E402
from repro_torch.core.timing import time_fn  # noqa: E402
from repro_torch.kernels import pchase as pc  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    steps = 1 << 12
    for size in (4 << 10, 32 << 10):
        perm = single_cycle_successors(size // 4, 0, dev)
        for g in (32, 64, 128, 256):
            pc.GRAPH_STEPS = g
            vals = []
            t0 = time.perf_counter()
            for _ in range(12):
                t = time_fn(pc.pchase_torch, perm, steps, warmup=2, reps=5)
                vals.append(t.min_s / steps * 1e9)
            per_call = (time.perf_counter() - t0) / 12 / 7
            print(f"size {size >> 10} KiB graph {g}: ns/load min {min(vals):.1f} median "
                  f"{statistics.median(vals):.1f} max {max(vals):.1f} (max/min "
                  f"{max(vals) / min(vals):.3f}); {per_call * 1e3:.2f} ms a call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
