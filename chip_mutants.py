#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s kernel checks, on one CUDA card.

    python3 chip_mutants.py [--out FILE] [--only flash|bandwidth]

Each mutant is a copy of ``src/repro_torch``, ``chip_smoke.py`` and the card
tests under ``build/mutants/<name>/`` with one deliberate fault in a kernel
or its launch geometry.  For the tree itself and for each mutant, a
subprocess builds that copy's kernels and runs the checks of the mutant's
family:

- ``flash``: faults of the bf16/fp16 flash kernel's key loop, most of them
  confined to late query rows.  ``chip_smoke.flash_model_case`` at gemma-2b's
  and zamba2-7b's shapes, then ``check_close`` (rtol = atol = 2e-2, a limit
  scaled by the output's largest value) and ``check_rows`` (each row's
  ||err|| / ||want|| against the fp32 plain version).  A mutant is caught
  when it fails ``check_rows`` at one shape or more, or the run.
- ``bandwidth``: faults of the axpy and stream_copy kernels.
  ``chip_smoke.axpy_checks`` and ``chip_smoke.copy_checks``, then the card
  tests of both kernels (``tests/test_torch_cuda.py -k "axpy or
  stream_copy"``).  A mutant is caught when a check or a test fails.

Prints one JSON object of the verdicts and times (also to ``--out``).
Exits 0 when the tree passes every check and every mutant is caught.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join("src", "repro_torch", "kernels")
FLASH = os.path.join(KERNELS, "csrc", "flash_attention.cu")
AXPY = os.path.join(KERNELS, "csrc", "axpy.cu")
MEMBW = os.path.join(KERNELS, "csrc", "membw.cu")
ARCHS = ("gemma-2b", "zamba2-7b")  # chip_smoke.FLASH_MODEL_SHAPES

# name: (what the fault does, text of the kernel, its replacement).  All but
# the last touch only blocks of query rows from 512 on, whose outputs are
# small beside row 0's, the largest value of the whole output.
FLASH_MUTANTS = {
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

UNROLL_AT = "template <int VB> constexpr int kUnrollAt = kUnroll;\n"
UNROLL_BY_WIDTH = "template <int VB> constexpr int kUnrollAt = 64 / VB;\n"
# name: (what the fault does, [(file, text, its replacement), ...])
BANDWIDTH_MUTANTS = {
    "axpy_partial_round_dropped": (
        "each block runs only the rounds whose vectors all lie in the tile: a tile "
        "whose vector count is not a multiple of threads x unroll loses its last round",
        [(AXPY, "  for (int r = 0; r < rounds; ++r) {\n",
          "  for (int r = 0; r < tile_vecs / (step * U); ++r) {\n")],
    ),
    "axpy_unroll_by_width": (
        "the unroll tuned to the width (64 / vec_bytes: 16, 8, 4 vectors) in axpy_geometry "
        "and the kernel, so every width keeps 64 bytes an array in flight a thread; the "
        "results stay right",
        [(os.path.join(KERNELS, "axpy.py"),
          "    per_round = -(-tile_vecs // AXPY_UNROLL)\n",
          "    AXPY_UNROLL = 64 // vec_bytes\n    per_round = -(-tile_vecs // AXPY_UNROLL)\n"),
         (AXPY, UNROLL_AT, UNROLL_BY_WIDTH)],
    ),
    "axpy_kernel_unroll_by_width": (
        "the same unroll by width in the kernel alone, axpy_geometry unchanged: its rounds "
        "then cover more than the tile at 4 and 8 bytes, masked; the results stay right",
        [(AXPY, UNROLL_AT, UNROLL_BY_WIDTH)],
    ),
    "copy_last_round_dropped": (
        "the blocks skip a round that reaches past the bulk's last vector: a size that is "
        "not a whole number of rounds loses its last partial round",
        [(MEMBW, "  for (long long base = blockIdx.x * round; base < n16; "
                 "base += round * gridDim.x) {\n",
          "  for (long long base = blockIdx.x * round; base + round <= n16; "
          "base += round * gridDim.x) {\n")],
    ),
    "copy_tail_skipped": (
        "the nbytes % 16 tail bytes are never copied",
        [(MEMBW, "  if (blockIdx.x == gridDim.x - 1 && t < nbytes) ob[t] = xb[t];\n",
          "  if (blockIdx.x == gridDim.x - 1 && t < (n16 << 4)) ob[t] = xb[t];\n")],
    ),
}


MUTANTS = {
    **{name: ("flash", what, [(FLASH, old, new)])
       for name, (what, old, new) in FLASH_MUTANTS.items()},
    **{name: ("bandwidth", what, edits) for name, (what, edits) in BANDWIDTH_MUTANTS.items()},
}

FLASH_CASE = r"""
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


BANDWIDTH_CASE = r"""
import json
import torch
import chip_smoke as cs

dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
out = {}
for check in ("axpy_checks", "copy_checks"):
    try:
        row = getattr(cs, check)(torch, dev, gen)
        out[check] = {"passed": True, **{k: row[k] for k in ("ms", "library_ms", "bound_ms")}}
        if "sweep_256mib" in row:
            out[check]["sweep_256mib_ms"] = {r["vec_bytes"]: r["ms"] for r in row["sweep_256mib"]}
    except AssertionError as e:
        out[check] = {"passed": False, "message": str(e)[:500]}
    torch.cuda.empty_cache()
print("VERDICTS " + json.dumps(out))
"""
CARD_TESTS = ("tests/test_torch_cuda.py", "-k", "axpy or stream_copy")


def make_copy(name: str, edits: list) -> str:
    """build/mutants/<name>/ holding the port, chip_smoke.py and the card
    tests, with each (file, old, new) edit applied."""
    dst = os.path.join(ROOT, "build", "mutants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(dst, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(dst, "tests"))
    for rel in ("chip_smoke.py", "pyproject.toml", "tests/conftest.py", CARD_TESTS[0]):
        shutil.copy(os.path.join(ROOT, rel), os.path.join(dst, rel))
    for rel, old, new in edits:
        path = os.path.join(dst, rel)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the text to mutate occurs {text.count(old)} times in "
                               f"{rel}, not once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def run_case(root: str, family: str) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src") + os.pathsep + root}
    case = FLASH_CASE if family == "flash" else BANDWIDTH_CASE
    proc = subprocess.run([sys.executable, "-c", case], cwd=root, capture_output=True, text=True,
                          timeout=900, env=env)
    for line in proc.stdout.splitlines():
        if line.startswith("VERDICTS "):
            res = json.loads(line.removeprefix("VERDICTS "))
            break
    else:
        return {"error": f"exit {proc.returncode}", "stderr": proc.stderr[-3000:]}
    if family == "bandwidth":
        tests = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rf", "-p",
                                "no:cacheprovider", "-m", "cuda", *CARD_TESTS], cwd=root,
                               capture_output=True, text=True, timeout=900, env=env)
        failed = [ln.split(" ")[1] for ln in tests.stdout.splitlines()
                  if ln.startswith("FAILED ")]
        res["card_tests"] = {"exit": tests.returncode, "failed": failed,
                             "summary": tests.stdout.strip().splitlines()[-1:]}
    return res


def caught(family: str, r: dict) -> dict:
    """Which checks a mutant's run failed."""
    if family == "flash":
        ran = all(arch in r for arch in ARCHS)
        return {
            "run_fails": not ran,
            "check_close_fails": ran and not all(r[a]["check_close"]["passed"] for a in ARCHS),
            "check_rows_fails": ran and not all(r[a]["check_rows"]["passed"] for a in ARCHS),
        }
    ran = "error" not in r
    return {
        "run_fails": not ran,
        **{f"{c}_fails": ran and not r[c]["passed"] for c in ("axpy_checks", "copy_checks")},
        "card_tests_fail": ran and r["card_tests"]["exit"] != 0,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON verdicts here")
    parser.add_argument("--only", choices=("flash", "bandwidth"), help="one family of mutants")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device visible", file=sys.stderr)
        return 1
    families = [args.only] if args.only else ["flash", "bandwidth"]
    results = {"tree": {fam: run_case(ROOT, fam) for fam in families}}
    for name, (fam, what, edits) in MUTANTS.items():
        if fam in families:
            results[name] = {"family": fam, "fault": what, **run_case(make_copy(name, edits), fam)}
    tree_ok = all(not any(caught(fam, results["tree"][fam]).values()) for fam in families)
    summary = {name: caught(results[name]["family"], results[name])
               for name in MUTANTS if name in results}
    results["summary"] = {"tree_passes": tree_ok, "mutants": summary}
    text = json.dumps(results, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    flash_caught = all(v["run_fails"] or v["check_rows_fails"]
                       for name, v in summary.items() if MUTANTS[name][0] == "flash")
    bandwidth_caught = all(any(v.values())
                           for name, v in summary.items() if MUTANTS[name][0] == "bandwidth")
    return 0 if tree_ok and flash_caught and bandwidth_caught else 1


if __name__ == "__main__":
    sys.exit(main())
