"""Run ``chip_smoke.py``'s serving phase (phase 10) from several checkouts
of the repo on one card, one process each, in the order given.

    python tools/serving_ab.py OLD NEW NEW OLD

Each TREE is the root of a checkout (for instance the parent commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists); its
own ``chip_smoke.serving_path`` and ``src/`` are imported, so each tree
builds and runs its own code.  Prints the phase's serving and decode-step
trace lines, prefixed by the tree, so two versions can be compared within
one machine's run.  Needs a CUDA card.
"""
from __future__ import annotations

import subprocess
import sys

_CHILD = """
import sys, time
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke as cs
dev = torch.device("cuda", 0)
t0 = time.perf_counter()
cs.serving_path(torch, dev, *cs.gemma_full(torch, dev))
print(f"phase with gemma-2b's init: {time.perf_counter() - t0:.1f} s", flush=True)
"""

_KEEP = ("serving dense", "serving paged", "serving: decode-step trace", "phase with")


def main(trees: list) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", _CHILD, tree], capture_output=True,
                              text=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            if line.startswith(_KEEP) or "Error" in line:
                print(f"[{tree}] {line}", flush=True)
        print(f"[{tree}] rc {proc.returncode}", flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
