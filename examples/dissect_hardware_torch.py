"""The paper, as a program, on the PyTorch port: dissect the card (or the
host) with the hand-written probe kernels and print a Table-3.1-style
report, hold the fit against the H100 datasheet record, then show what the
knowledge buys you (autotuned tiles vs naive).  It runs on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/dissect_hardware_torch.py [--full]
    PYTHONPATH=src python examples/dissect_hardware_torch.py --device cpu
"""
import argparse

import repro_torch.hw as hw
from repro_torch.core.autotune import choose_matmul_tiles, matmul_time_model
from repro_torch.core.dissect import dissect_measure, dissect_model
from repro_torch.core.timing import resolve_device
from repro_torch.hw import H100, T4_PAPER, TPU_V5E


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails with no card visible) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: fail before measuring

    print(f"=== measured: {args.device} ===")
    rep = dissect_measure(quick=not args.full, device=args.device)
    print(f"{'level':>8} | {'latency':>10} | {'capacity':>12}")
    for i, (lat, cap) in enumerate(rep.detected_levels):
        cap_s = f"{cap >> 10} KiB" if cap else "—"
        print(f"{i:>8} | {lat:8.2f} ns | {cap_s:>12}")
    mm = rep.probe_results["matmul_throughput"]
    print(f"matmul peak: {max(mm['y']):.1f} GFLOP/s; "
          f"stream bw: {rep.hardware.main_memory_Bps / 1e9:.1f} GB/s")

    # dissect_measure registered the fit into the spec DB as "measured-host"
    print(f"\n=== the fit vs the {H100.name} datasheet record ===")
    c = hw.compare("measured-host", H100.name, dtypes=["float32"])
    print(f"  fp32 peak ratio: {c['peak_ratio'].get('float32', 0):.4f}x; "
          f"memory bw ratio: {c['main_memory_Bps_ratio']:.3f}x")

    print("\n=== modeled: TPU v5e (the reference's dry-run target) ===")
    mrep = dissect_model(TPU_V5E)
    for name, pr in mrep.probe_results.items():
        ys = pr["y"]
        print(f"  {name}: {min(ys):.1f} .. {max(ys):.1f} {pr['unit']}")

    print("\n=== paper cross-check: T4 Table 3.1 constants ===")
    for lvl in T4_PAPER.levels:
        print(f"  {lvl.name}: {lvl.size_bytes >> 10} KiB, {lvl.latency_ns:.1f} ns "
              f"({lvl.latency_ns * 1.59:.0f} cycles @1.59GHz)")

    print("\n=== spec DB: the fit vs the paper's T4 ===")
    c = hw.compare("measured-host", "T4")
    print(f"  fp32 peak ratio: {c['peak_ratio'].get('float32', 0):.4f}x; "
          f"memory bw ratio: {c['main_memory_Bps_ratio']:.3f}x")
    c = hw.compare("T4", "P4")
    print("=== spec DB: T4 vs P4 (the paper's own columns) ===")
    for dt, r in c["peak_ratio"].items():
        print(f"  {dt:>8}: {r:8.2f}x")

    print("\n=== knowledge -> optimization (Ch.1) ===")
    t_naive, _ = matmul_time_model(8192, 8192, 8192, 128, 128, 128, "bfloat16", TPU_V5E)
    best = choose_matmul_tiles(8192, 8192, 8192, "bfloat16")
    print(f"  8192^3 bf16: naive 128-tiles {t_naive * 1e3:.2f} ms -> "
          f"autotuned ({best.bm},{best.bk},{best.bn}) {best.predicted_s * 1e3:.2f} ms "
          f"({t_naive / best.predicted_s:.2f}x)")

    if args.out:
        with open(args.out, "w") as f:
            f.write(rep.to_json())
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
