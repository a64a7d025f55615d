#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s kernel checks, on one CUDA card.

    python3 chip_mutants.py [--out FILE] [--only flash|bandwidth|matmul|ssm]

Each mutant is a copy of ``src/repro_torch``, ``chip_smoke.py`` and the card
tests under ``build/mutants/<name>/`` with one deliberate fault in a kernel
or its launch geometry.  For the tree itself and for each mutant, a
subprocess builds that copy's kernels and runs the checks of the mutant's
family:

- ``flash``: faults of the bf16/fp16 flash kernel's key loop, most of them
  confined to query rows from 512 on.  ``chip_smoke.flash_model_case`` at
  each ``FLASH_MODEL_SHAPES`` shape past S 512 (the summary names the others,
  which no mutant reaches), then ``check_close`` (rtol = atol = 2e-2, a limit
  scaled by the output's largest value) and ``check_rows`` (each row's
  ||err|| / ||want|| against the fp32 plain version).  A mutant is caught
  when it fails ``check_rows`` at one shape or more, or the run.
- ``bandwidth``: faults of the axpy and stream_copy kernels.
  ``chip_smoke.axpy_checks`` and ``chip_smoke.copy_checks``, then the card
  tests of both kernels (``tests/test_torch_cuda.py -k "axpy or
  stream_copy"``).  A mutant is caught when a check or a test fails.
- ``matmul``: faults of the tensor-core matmul (its fp8 promotion, the
  8-bit B transpose, its K loop, its store and its casts).
  ``chip_smoke.matmul_lp_checks`` (every instance against the plain version
  at 2048^3, 4096^3 and 300 x 200 x 100), then the card tests of the matmul
  (``-k matmul``).  A mutant is caught when a check or a test fails.
- ``ssm``: faults of the ssm_scan kernel's wgmma route (the bf16 path)
  that change y by ~1-2 % where they act: three in its chunk outputs, two
  in the state passed between chunks.  ``chip_smoke.ssm_bf16_case`` at
  zamba2-7b's shape, chunk 256, at the init's decay and at a slow one, then
  ``check_close`` (rtol = atol = 2e-2 of the output's largest value) and
  ``check_rows`` (each row's ||err|| / ||want|| within SSM_ROW_RTOL of the
  fp32 plain output, SSM_SLOW_ROW_RTOL at the slow decay).  A mutant is
  caught when it fails ``check_rows`` at either decay, or the run; each is
  meant to pass ``check_close``, and the state faults to show only at the
  slow decay, where the carried state counts.

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

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join("src", "repro_torch", "kernels")
FLASH = os.path.join(KERNELS, "csrc", "flash_attention.cu")
AXPY = os.path.join(KERNELS, "csrc", "axpy.cu")
MEMBW = os.path.join(KERNELS, "csrc", "membw.cu")
MATMUL = os.path.join(KERNELS, "csrc", "matmul.cu")
COMMON = os.path.join(KERNELS, "csrc", "common.cuh")
SSM = os.path.join(KERNELS, "csrc", "ssm_scan.cu")
# chip_smoke.FLASH_MODEL_SHAPES: (B, S, H, Hkv, hd) by name.  The flash
# mutants act on query rows from 512 on, so they run at the shapes past
# S 512; the others (internvl2-76b's S 512, whisper-base's S 32) no mutant
# reaches, and the summary names them.
ARCHS = tuple(n for n, shape in cs.FLASH_MODEL_SHAPES.items() if shape[1] > 512)
NOT_REACHED = tuple(n for n in cs.FLASH_MODEL_SHAPES if n not in ARCHS)
DECAYS = ("fast", "slow")  # the ssm case's two decays

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


MATMUL_MUTANTS = {
    "fp8_unpromoted": (
        "fp8 accumulates all of K in the tensor cores' accumulator, never promoted to fp32",
        [(MATMUL, "  constexpr bool kPromote = std::is_same<TI, __nv_fp8_e4m3>::value;\n",
          "  constexpr bool kPromote = false;\n")],
    ),
    "int8_b_not_transposed": (
        "int8's B reaches the kernel as it lies, (K, N), where the kernel reads B^T (N, K)",
        [(os.path.join(KERNELS, "matmul.py"),
          "    b = transpose8(b) if a.element_size() == 1 else _tma_operand(b)\n",
          "    b = transpose8(b) if a.dtype == torch.float8_e4m3fn else _tma_operand(b)\n")],
    ),
    "last_k_tile_dropped": (
        "the tensor-core kernel stops one K tile short",
        [(MATMUL, "  const int n_k = (K + kK - 1) / kK;\n",
          "  const int n_k = (K + kK - 1) / kK - 1;\n")],
    ),
    "edge_column_past_n": (
        "the store's column mask lets the column at N through: one value past each row's end",
        [(MATMUL, "      if (row < M && col < N)\n", "      if (row < M && col <= N)\n")],
    ),
    "int8_output_wraps": (
        "int8 outputs wrap instead of saturating (torch's .to)",
        [(MATMUL, "        put(static_cast<int8_t*>(c), static_cast<int8_t>(max(-128, min(127, v0))),\n"
                  "            static_cast<int8_t>(max(-128, min(127, v1))));\n",
          "        put(static_cast<int8_t*>(c), static_cast<int8_t>(v0), static_cast<int8_t>(v1));\n")],
    ),
    "fp8_output_saturates": (
        "fp8 outputs saturate to 448 (cvt's satfinite alone) instead of giving NaN past it",
        [(COMMON, "  r.__x = fabsf(v) <= 464.f ? __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3)\n",
          "  r.__x = true ? __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3)\n")],
    ),
}

# name: (what the fault does, text of the kernel, its replacement), all in the
# wgmma route's passes 2 and 3: each changes y by ~1-3 % where it acts, under
# check_close's limit (2e-2 of the largest |y| beside an error of 2e-2 of the
# value itself) and over the row checks' (~5e-3)
_W = "                            ? sc[4 * jj + e] * clip_exp(at[e / 2] - as[2 * jj + (e % 2)])\n"
SSM_MUTANTS = {
    "late_scores_scaled": (
        "chunks from step 512 on scale the intra-chunk scores by 0.99",
        _W, _W.replace("? sc[4 * jj + e] *", "? (t0 >= 512 ? 0.99f : 1.f) * sc[4 * jj + e] *"),
    ),
    "late_decay_weakened": (
        "chunks from step 512 on take 0.98 of the decay between two steps in the scores",
        _W, _W.replace("clip_exp(at[e / 2] - as[2 * jj + (e % 2)])",
                       "clip_exp((t0 >= 512 ? 0.98f : 1.f) * (at[e / 2] - as[2 * jj + (e % 2)]))"),
    ),
    "one_head_scaled": (
        "head 7's y is scaled by 0.98",
        "  T* yb = y + ((static_cast<long long>(b) * S + t0) * H + h) * P;\n",
        "  if (h == 7)\n    for (int k = 0; k < PW / 2; ++k) acc[k] *= 0.98f;\n"
        "  T* yb = y + ((static_cast<long long>(b) * S + t0) * H + h) * P;\n",
    ),
    "late_state_scaled": (
        "the state entering chunks from step 512 on is scaled by 0.98 in y",
        "      acc[k] *= e[(k % 4) / 2];\n",
        "      acc[k] *= (t0 >= 512 ? 0.98f : 1.f) * e[(k % 4) / 2];\n",
    ),
    "one_chunk_decay_weakened": (
        "the state passing takes chunk 1's exp(atot) as exp(0.97 atot): the state carried "
        "into chunks 2 and 3 decays too little",
        "    const float d = expf(atot[static_cast<long long>(c) * L]);\n",
        "    const float d = expf((c == 1 ? 0.97f : 1.f) * atot[static_cast<long long>(c) * L]);\n",
    ),
}

MUTANTS = {
    **{name: ("flash", what, [(FLASH, old, new)])
       for name, (what, old, new) in FLASH_MUTANTS.items()},
    **{name: ("bandwidth", what, edits) for name, (what, edits) in BANDWIDTH_MUTANTS.items()},
    **{name: ("matmul", what, edits) for name, (what, edits) in MATMUL_MUTANTS.items()},
    **{name: ("ssm", what, [(SSM, old, new)]) for name, (what, old, new) in SSM_MUTANTS.items()},
}
FAMILIES = ("flash", "bandwidth", "matmul", "ssm")

FLASH_CASE = r"""
import json, sys
import torch
import chip_smoke as cs

dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
out = {}
for arch, (b, s, heads, kv_heads, hd) in cs.FLASH_MODEL_SHAPES.items():
    if s <= 512:  # no mutant reaches a query row past 512 here
        continue
    _, _, got, want32 = cs.flash_model_case(torch, dev, gen, heads, kv_heads, hd, b=b, s=s)
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
MATMUL_CASE = r"""
import json
import torch
import chip_smoke as cs

from repro_torch.kernels import ref
from repro_torch.kernels.matmul import matmul_cuda

dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
# fp8 into fp32 at K 4096, each row against the plain fp32 output: the
# tensor cores' accumulation error, promoted or not (recorded, not checked)
a, b = cs.matmul_operands(torch, dev, gen, torch.float8_e4m3fn, 4096, 4096, 4096)
out = {"fp8_row_rel_err_k4096": cs.row_rel_err(matmul_cuda(a, b, out_dtype=torch.float32),
                                               ref.matmul_ref(a, b, torch.float32))}
del a, b
try:
    rows = cs.matmul_lp_checks(torch, dev, gen)
    out["matmul_lp_checks"] = {"passed": True, **{
        k: {"row_rel_err": r["row_rel_err"], "ms": r["ms"]} for k, r in rows.items()
        if k != "matmul_transpose"}}
except AssertionError as e:
    out["matmul_lp_checks"] = {"passed": False, "message": str(e)[:500]}
print("VERDICTS " + json.dumps(out))
"""

SSM_CASE = r"""
import json
import torch
import chip_smoke as cs

dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
out = {}
for decay, shift, rows in (("fast", 0.0, cs.SSM_ROW_RTOL), ("slow", -5.0, cs.SSM_SLOW_ROW_RTOL)):
    _, got, want, want32 = cs.ssm_bf16_case(torch, dev, gen, shift=shift)
    verdicts = {}
    for check, run in (
        ("check_close", lambda: cs.check_close("ssm", got.float(), want.float(), 2e-2, 2e-2)),
        ("check_rows", lambda: cs.check_rows("ssm", got, want32, rows)),
    ):
        try:
            verdicts[check] = {"passed": True, "err": run()}
        except AssertionError as e:
            verdicts[check] = {"passed": False, "message": str(e)}
    verdicts["max_abs_err"] = cs.max_abs_err(got.float(), want.float())
    verdicts["row_rel_err"] = cs.row_rel_err(got, want32)
    out[decay] = verdicts
    del got, want, want32
print("VERDICTS " + json.dumps(out))
"""
CASES = {"flash": FLASH_CASE, "bandwidth": BANDWIDTH_CASE, "matmul": MATMUL_CASE,
         "ssm": SSM_CASE}
CARD_TESTS = {"bandwidth": "axpy or stream_copy", "matmul": "matmul"}
CARD_TEST_FILE = "tests/test_torch_cuda.py"


def make_copy(name: str, edits: list) -> str:
    """build/mutants/<name>/ holding the port, chip_smoke.py and the card
    tests, with each (file, old, new) edit applied."""
    dst = os.path.join(ROOT, "build", "mutants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(dst, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(dst, "tests"))
    for rel in ("chip_smoke.py", "pyproject.toml", "tests/conftest.py", CARD_TEST_FILE):
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
    proc = subprocess.run([sys.executable, "-c", CASES[family]], cwd=root, capture_output=True,
                          text=True, timeout=900, env=env)
    for line in proc.stdout.splitlines():
        if line.startswith("VERDICTS "):
            res = json.loads(line.removeprefix("VERDICTS "))
            break
    else:
        return {"error": f"exit {proc.returncode}", "stderr": proc.stderr[-3000:]}
    if family in CARD_TESTS:
        tests = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rf", "-p",
                                "no:cacheprovider", "-m", "cuda", CARD_TEST_FILE, "-k",
                                CARD_TESTS[family]], cwd=root,
                               capture_output=True, text=True, timeout=900, env=env)
        failed = [ln.split(" ")[1] for ln in tests.stdout.splitlines()
                  if ln.startswith("FAILED ")]
        res["card_tests"] = {"exit": tests.returncode, "failed": failed,
                             "summary": tests.stdout.strip().splitlines()[-1:]}
    return res


def caught(family: str, r: dict) -> dict:
    """Which checks a mutant's run failed."""
    if family in ("flash", "ssm"):  # a case per LM shape, or per decay
        cases = ARCHS if family == "flash" else DECAYS
        ran = all(case in r for case in cases)
        verdicts = {
            "run_fails": not ran,
            **{f"{check}_fails": ran and not all(r[case][check]["passed"] for case in cases)
               for check in ("check_close", "check_rows")},
        }
        verdicts.update({f"check_rows_fails_{case}": ran and not r[case]["check_rows"]["passed"]
                         for case in cases})
        return verdicts
    ran = "error" not in r
    checks = ("axpy_checks", "copy_checks") if family == "bandwidth" else ("matmul_lp_checks",)
    return {
        "run_fails": not ran,
        **{f"{c}_fails": ran and not r[c]["passed"] for c in checks},
        "card_tests_fail": ran and r["card_tests"]["exit"] != 0,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON verdicts here")
    parser.add_argument("--only", choices=FAMILIES, help="one family of mutants")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device visible", file=sys.stderr)
        return 1
    families = [args.only] if args.only else list(FAMILIES)
    results = {"tree": {fam: run_case(ROOT, fam) for fam in families}}
    for name, (fam, what, edits) in MUTANTS.items():
        if fam in families:
            results[name] = {"family": fam, "fault": what, **run_case(make_copy(name, edits), fam)}
    tree_ok = all(not any(caught(fam, results["tree"][fam]).values()) for fam in families)
    summary = {name: caught(results[name]["family"], results[name])
               for name in MUTANTS if name in results}
    for name, v in summary.items():
        if MUTANTS[name][0] == "flash":
            v["shapes_not_reached"] = list(NOT_REACHED)
    results["summary"] = {"tree_passes": tree_ok, "mutants": summary}
    text = json.dumps(results, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    rows_caught = all(v["run_fails"] or v["check_rows_fails"]
                      for name, v in summary.items() if MUTANTS[name][0] in ("flash", "ssm"))
    others_caught = all(any(v.values()) for name, v in summary.items()
                        if MUTANTS[name][0] in ("bandwidth", "matmul"))
    return 0 if tree_ok and rows_caught and others_caught else 1


if __name__ == "__main__":
    sys.exit(main())
