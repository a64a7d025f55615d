"""Readings for setting a cell's limits, many seeds in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 11,12,13 --seconds 10
        [--control] [--fault half_batch] [--set lanes=8 --set clients=8] [--out FILE]

For each seed, one run of the cell as ``run.py`` makes it (the harness's
``execute``), with a window of ``--seconds``: the check's readings of the
program and its verdict against the cell's limits.  With ``--control`` the
float8 reference's readings are taken too and the check judges them in the
program's place, so the verdict is the control's.  One JSON line a seed.
``--fault`` plants one of the faults a cell can have in the program, to
read what it gives.  ``--set`` overrides a traffic parameter (a sweep).
The benchmark's own runs never run this.
"""
import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def plant(fault: str, patch=setattr) -> None:
    """Break the timed path where it is produced.  ``patch(obj, name,
    value)`` sets an attribute (a test passes its monkeypatch's)."""
    import repro_torch.models as models
    import repro_torch.serve.engine as engine
    import repro_torch.train.step as step

    if fault == "half_batch":  # the loss over half the rows: the mean taken over the rest
        build = models.build_model

        def half(cfg, device="cuda"):
            m = build(cfg, device)
            loss = m.loss_fn
            return dataclasses.replace(m, loss_fn=lambda p, b: loss(
                p, {k: v[: v.shape[0] // 2] for k, v in b.items()}))

        patch(models, "build_model", half)
    elif fault == "unchanged":  # the step returns its state as it was given
        import torch

        make = step.make_train_step

        def frozen(*a, **k):
            inner = make(*a, **k)

            def run(state, batch):  # the step works on a copy (it updates in place)
                copy = step.TrainState(
                    _clone(state.params), type(state.opt)(state.opt.step.clone(),
                                                          _clone(state.opt.mu),
                                                          _clone(state.opt.nu)))
                return state, inner(copy, batch)[1]
            return run

        def _clone(tree):
            return ({k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict)
                    else torch.clone(tree))

        patch(step, "make_train_step", frozen)
    elif fault == "token":  # every 7th sampling returns the least likely ids
        init = engine.ServeEngine.__init__
        calls = {"n": 0}

        def wrong(logits):
            calls["n"] += 1
            return logits.argmin(dim=-1).int() if calls["n"] % 7 == 0 else engine.greedy(logits)

        def init_wrong(self, model, params, config, scheduler=None):
            init(self, model, params, dataclasses.replace(config, sampler=wrong), scheduler)

        patch(engine.ServeEngine, "__init__", init_wrong)
    elif fault == "cut_short":  # every other request stops at half its tokens
        reason = engine.ServeEngine._finish_reason

        def early(self, lane, session, token):
            if session.rid % 2 == 0 and 2 * len(session.out) >= session.max_new_tokens > 1:
                return engine.FINISH_MAX_LEN
            return reason(self, lane, session, token)

        patch(engine.ServeEngine, "_finish_reason", early)
    elif fault == "answer":  # the prefill's logits and cache altered where they are made
        build = models.build_model

        def skewed(cfg, device="cuda"):
            m = build(cfg, device)
            prefill = m.prefill

            def wrong(params, batch, max_len=None):
                logits, cache = prefill(params, batch, max_len)
                cache["ssm"][-1].mul_(1.5)
                return logits * 1.05, cache
            return dataclasses.replace(m, prefill=wrong)

        patch(models, "build_model", skewed)
    else:
        raise SystemExit(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    harness.cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    cell = harness.load_cell(ROOT, args.workload)
    sets = {k: json.loads(v) for k, v in (s.split("=", 1) for s in args.set)}
    out = open(args.out, "a") if args.out else None
    if args.fault:
        plant(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                              device=torch.device("cuda", 0), t_start=time.perf_counter(),
                              torch=torch, overrides={"traffic": sets})
        torch.cuda.reset_peak_memory_stats()
        result, _ = harness.execute(ctx, control=args.control)
        line = {"workload": args.workload, "seed": seed, "seconds": args.seconds,
                "control": args.control, "fault": args.fault, "set": sets,
                "correct": result["correct"], "checks": result["checks"],
                "attempted": result["attempted"], "failed": result["failed"],
                "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                "run_s": time.perf_counter() - ctx.t_start, "readings": ctx.readings}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del result, ctx
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
