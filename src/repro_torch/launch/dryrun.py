"""Multi-pod dry run: one rank's program of every (arch x shape x mesh)
cell on the production mesh (16x16 single-pod / 2x16x16 multi-pod), with
its per-device memory, FLOPs and collective traffic for the roofline report.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell with XLA on 512 fake devices and reads the compiled program.  Here
``Cell.lower`` runs rank 0's own SPMD program on the ``meta`` device: no
world, no process group, no storage (see ``launch/cell.py``).  So no fake
devices are needed and there is no ``XLA_FLAGS`` line.  Run as:

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out artifacts/dryrun_torch]

The record keeps the reference's keys.  ``lower_s`` is the seconds to cut
rank 0's shards of the global ``meta`` arguments and ``compile_s`` the
seconds its step took to run on them (the reference's lowering and
compilation have no other twin).  ``memory`` is the counted costs
(``perfmodel.extract_costs``: no temporaries are measured on ``meta``).
``--save-hlo`` writes the recorded collective calls, one JSON object a line
(``<cell>.calls.jsonl``), in place of HLO text.

Exit code is non-zero if any requested cell fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

from repro_torch.configs import CONFIGS, SHAPES, get_config, get_shape
from repro_torch.launch.cell import Cell, analytic_memory, build_cell, cost_reference
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.perfmodel.hlo import recorded_stats
from repro_torch.perfmodel.roofline import roofline


def run_cell(
    cell: Cell,
    out_dir: Path,
    save_hlo: bool = False,
    ref: dict | None = None,
    hw: str = "tpu-v5e",
) -> dict:
    """Dry-run one cell at rank 0 and record costs + roofline terms against
    ``hw`` (any part in the ``repro_torch.hw`` spec database)."""
    low = cell.lower(rank=0)
    costs = low.costs
    coll = recorded_stats(low.calls)
    chips = cell.mesh.size

    # the reference's loop-trip-count correction (XLA's cost_analysis counts
    # a while body once).  The port's count has no loop to correct, so the
    # ratio is 1.0 unless rank 0's count falls below the loop-free global
    # count's share: a rank that computes less than 1/chips of the work (a
    # split the rules give unevenly).
    if ref is None:
        ref = cost_reference(cell.cfg, cell.shape)
    if ref.get("global_flops"):
        scanned = max(costs.flops_per_device, 1.0)
        ratio = max((ref["global_flops"] / chips) / scanned, 1.0)
        costs.flops_per_device = ref["global_flops"] / chips
        costs.bytes_per_device = costs.bytes_per_device * ratio
    else:
        ratio = 1.0

    tokens = (
        cell.shape.global_batch
        if cell.shape.kind == "decode"
        else cell.shape.global_batch * cell.shape.seq_len
    )
    rt = roofline(
        costs,
        coll,
        chips=chips,
        kind=cell.shape.kind,
        n_params_active=cell.n_params_active,
        tokens=tokens,
        hw=hw,
    )
    rec = {
        "cell": cell.name,
        "hw": rt.hw,
        "arch": cell.cfg.name,
        "shape": cell.shape.name,
        "mesh": dict(cell.mesh.shape),
        "chips": chips,
        "kind": cell.shape.kind,
        "n_params": cell.n_params,
        "n_params_active": cell.n_params_active,
        "lower_s": low.build_s,
        "compile_s": low.run_s,
        "loop_correction": ratio,
        "cost_reference": ref,
        "memory": costs.summary(),
        "analytic_memory": analytic_memory(cell),
        "collectives": coll.summary(),
        "roofline": rt.summary(),
        "ok": True,
    }
    if save_hlo:
        (out_dir / f"{cell.name}.calls.jsonl").write_text(
            "".join(json.dumps(c._asdict()) + "\n" for c in low.calls))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None, help="arch id (repeatable)")
    ap.add_argument("--shape", action="append", default=None, help="shape id (repeatable)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's recorded collective calls (<cell>.calls.jsonl)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None, help="override per-arch value")
    ap.add_argument("--hw", default="tpu-v5e",
                    help="repro_torch.hw spec-DB part to roofline against (name or alias)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    archs = args.arch or sorted(CONFIGS)
    shapes = args.shape or list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        if args.microbatches:
            cfg = cfg.replace(train_microbatches=args.microbatches)
        for shape_name in shapes:
            shape = get_shape(shape_name)
            if not cfg.supports_shape(shape):
                rec = {
                    "cell": f"{arch}__{shape_name}",
                    "arch": arch,
                    "shape": shape_name,
                    "ok": True,
                    "skipped": "inapplicable (full-attention arch on long_500k; see DESIGN.md)",
                }
                (out_dir / f"{arch}__{shape_name}__skip.json").write_text(json.dumps(rec, indent=2))
                print(f"[skip] {arch} x {shape_name}: inapplicable")
                continue
            ref = None  # shared across meshes for this (arch, shape)
            for multi in meshes:
                tag = "multi" if multi else "single"
                path = out_dir / f"{arch}__{shape_name}__{tag}.json"
                if args.skip_existing and path.exists():
                    try:
                        if json.loads(path.read_text()).get("ok"):
                            print(f"[keep] {path.name}")
                            continue
                    except Exception:  # noqa: BLE001
                        pass
                mesh = make_production_mesh(multi_pod=multi)
                try:
                    t_cell = time.time()
                    cell = build_cell(cfg, shape, mesh)
                    if ref is None:
                        t0 = time.time()
                        ref = cost_reference(cfg, shape)
                        print(f"[ref]  {arch} x {shape_name}: "
                              f"{ref['global_flops']/1e12:.1f} TF global ({time.time()-t0:.0f}s)")
                    rec = run_cell(cell, out_dir, save_hlo=args.save_hlo, ref=ref, hw=args.hw)
                    rec["cell_s"] = time.time() - t_cell
                    an_gib = rec["analytic_memory"]["analytic_peak_bytes"] / 2**30
                    print(
                        f"[ok]   {rec['cell']}: run {rec['compile_s']:.1f}s, "
                        f"analytic mem/dev {an_gib:.2f} GiB, "
                        f"dominant {rec['roofline']['dominant']}, "
                        f"roofline {rec['roofline']['roofline_fraction']:.3f}"
                    )
                except Exception as e:  # noqa: BLE001
                    n_fail += 1
                    rec = {
                        "cell": f"{arch}__{shape_name}__{tag}",
                        "arch": arch,
                        "shape": shape_name,
                        "mesh_tag": tag,
                        "ok": False,
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    print(f"[FAIL] {arch} x {shape_name} x {tag}: {type(e).__name__}: {e}")
                path.write_text(json.dumps(rec, indent=2))
    print(f"done; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
