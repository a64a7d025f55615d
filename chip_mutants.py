#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s flash_attention agreement checks,
on one CUDA card.

    python3 chip_mutants.py [--out FILE]

Each mutant is a copy of ``src/repro_torch`` and ``chip_smoke.py`` under
``build/mutants/<name>/`` whose ``csrc/flash_attention.cu`` carries one
deliberate fault of the bf16/fp16 kernel's key loop, most of them confined
to late query rows.  For the tree itself and for each mutant, a subprocess
builds that copy's kernels and runs ``chip_smoke.flash_model_case`` at
gemma-2b's and zamba2-7b's shapes, then both of ``chip_smoke``'s checks on the result: ``check_close`` (rtol = atol =
2e-2, a limit scaled by the output's largest value) and ``check_rows`` (each
row's ||err|| / ||want|| against the fp32 plain version).  Prints one JSON
object of the verdicts (also to ``--out``).  Exits 0 when the tree passes
both checks at both shapes and every mutant fails ``check_rows`` at one
shape or more, or fails the run outright.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL = os.path.join("src", "repro_torch", "kernels", "csrc", "flash_attention.cu")
ARCHS = ("gemma-2b", "zamba2-7b")  # chip_smoke.FLASH_MODEL_SHAPES

# name: (what the fault does, text of the kernel, its replacement).  All but
# the last touch only blocks of query rows from 512 on, whose outputs are
# small beside row 0's, the largest value of the whole output.
MUTANTS = {
    "late_last_tile_skipped": (
        "blocks of rows >= 512 skip their last key tile",
        "    if (kv0 < wg_hi) {\n",
        "    if (kv0 < wg_hi && (t + 1 < n_tiles || q0 < 512)) {\n",
    ),
    "late_stale_stage": (
        "blocks of rows >= 512 load no key tile from tile 4 on: the stage still "
        "holds tile t - 2 when it is read",
        "    mbar_expect_tx(full(s), 2 * L::kTileBytes);\n",
        "    if (t >= 4 && q0 >= 512) {\n      mbar_arrive(full(s));\n      return;\n    }\n"
        "    mbar_expect_tx(full(s), 2 * L::kTileBytes);\n",
    ),
    "late_rescale_missed": (
        "blocks of rows >= 512 do not rescale O by the running max's correction "
        "from tile 4 on",
        "        acc[i] *= corr[(i % 4) / 2];\n",
        "        if (t < 4 || q0 < 512) acc[i] *= corr[(i % 4) / 2];\n",
    ),
    "late_scale_off": (
        "blocks of rows >= 512 scale the scores by 0.9354 (sqrt(112 / 128)) too much",
        "  const float sl2 = scale * kLog2e;\n",
        "  const float sl2 = (q0 >= 512 ? 0.9354f : 1.f) * scale * kLog2e;\n",
    ),
    "late_diagonal_masked": (
        "blocks of rows >= 512 mask each row's own key (an off-by-one in the causal mask)",
        "(causal && key > q_offset + row0 + 8 * r)",
        "(causal && key > q_offset + row0 + 8 * r - (q0 >= 512))",
    ),
    "wrong_parity": (
        "every block waits on the full barrier at parity 0, so from tile 2 on "
        "a stage may be read before its new tile has landed",
        "    mbar_wait(full(s), (t / kStages) & 1);\n",
        "    mbar_wait(full(s), 0);\n",
    ),
}

CASE = r"""
import json, sys
import torch
import chip_smoke as cs

dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
out = {}
for arch, (heads, kv_heads, hd) in cs.FLASH_MODEL_SHAPES.items():
    _, _, got, want32 = cs.flash_model_case(torch, dev, gen, heads, kv_heads, hd)
    want = want32.to(got.dtype)
    verdicts = {}
    for check, run in (
        ("check_close", lambda: cs.check_close(arch, got.float(), want.float(), 2e-2, 2e-2)),
        ("check_rows", lambda: cs.check_rows(arch, got, want32, cs.FLASH_ROW_RTOL["bfloat16"])),
    ):
        try:
            verdicts[check] = {"passed": True, "err": run()}
        except AssertionError as e:
            verdicts[check] = {"passed": False, "message": str(e)}
    verdicts["max_abs_err"] = cs.max_abs_err(got, want)
    verdicts["row_rel_err"] = cs.row_rel_err(got, want32)
    out[arch] = verdicts
    del got, want32, want
print("VERDICTS " + json.dumps(out))
"""


def make_copy(name: str, old: str, new: str) -> str:
    """build/mutants/<name>/ holding the port and chip_smoke.py, the kernel mutated."""
    dst = os.path.join(ROOT, "build", "mutants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(dst, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    path = os.path.join(dst, KERNEL)
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: the text to mutate occurs {text.count(old)} times, not once")
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    return dst


def run_case(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CASE], cwd=root, capture_output=True, text=True,
                          timeout=900, env={**os.environ, "PYTHONPATH": root})
    for line in proc.stdout.splitlines():
        if line.startswith("VERDICTS "):
            return json.loads(line.removeprefix("VERDICTS "))
    return {"error": f"exit {proc.returncode}", "stderr": proc.stderr[-3000:]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON verdicts here")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device visible", file=sys.stderr)
        return 1
    results = {"tree": run_case(ROOT)}
    for name, (what, old, new) in MUTANTS.items():
        results[name] = {"fault": what, **run_case(make_copy(name, old, new))}
    tree = results["tree"]
    tree_ok = all(arch in tree and tree[arch]["check_close"]["passed"]
                  and tree[arch]["check_rows"]["passed"] for arch in ARCHS)
    summary = {}
    for name in MUTANTS:
        r = results[name]
        ran = all(arch in r for arch in ARCHS)
        summary[name] = {
            "run_fails": not ran,
            "check_close_fails": ran and not all(r[a]["check_close"]["passed"] for a in ARCHS),
            "check_rows_fails": ran and not all(r[a]["check_rows"]["passed"] for a in ARCHS),
        }
    results["summary"] = {"tree_passes": tree_ok, "mutants": summary}
    text = json.dumps(results, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    caught = all(v["run_fails"] or v["check_rows_fails"] for v in summary.values())
    return 0 if tree_ok and caught else 1


if __name__ == "__main__":
    sys.exit(main())
