"""Runs of a cell on the CPU at the program's ``reduced()`` sizes, for the
benchmark's own tests: the harness's look for a card is skipped, the rest of
a run is driven as on the card."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

#: the traffic of each driver cut to the reduced sizes
TRAFFIC = {
    "serve_closed": {"clients": 2, "lanes": 2, "page_size": 4, "prefill_chunk": 8, "max_len": 64,
             "prompt_tokens": {"dist": "log_normal", "median": 16, "sigma": 0.5, "max": 48},
             "output_tokens": {"dist": "log_normal", "median": 4, "sigma": 0.5, "min": 2},
             "block": 8, "drain_limit_s": 30, "sample_min_tokens": 12},
    "prefill_batch": {"batch": 1, "seq": 32, "max_len": 32},
    "train_steps": {"batch": 2, "seq": 16, "prefetch": 0},
}


#: each driver's window at the reduced sizes: long enough for some ticks on a
#: busy host
SECONDS = {"serve_closed": 2.0, "prefill_batch": 2.0, "train_steps": 0.5}


def context(workload: str, seed: int = 1234, seconds: float | None = None, *,
            trace: bool = False,
            compute: str = "bfloat16", root: Path = ROOT, limits: dict | None = None):
    """A Context for ``workload`` on the CPU, the program at its reduced
    sizes computing in ``compute``, and the traffic cut to match."""
    import torch

    cell = harness.load_cell(root, workload)
    if limits is not None:
        cell.limits = limits
    if seconds is None:
        seconds = SECONDS[cell.traffic["driver"]]
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                          device=torch.device("cpu"), t_start=time.perf_counter(), torch=torch)
    port = {"dtype": compute, **({"n_layers": 2} if cell.config["model"].get("n_experts")
                                  else {})}
    ctx.overrides = {"reduced": True, "port": port, "traffic": TRAFFIC[cell.traffic["driver"]]}
    from repro_torch.configs import get_config

    cfg = get_config(cell.config["port"]["config"]).reduced()
    cfg = cfg.replace(**{**cell.config["port"].get("overrides", {}), **port})
    model = {k: getattr(cfg, k) for k in cell.config["model"] if hasattr(cfg, k)}
    if "shared_attn_calls" in cell.config["model"]:
        per = cfg.macro_size * cfg.attn_every_k_macro
        model["shared_attn_calls"] = cfg.n_layers // per + (1 if cfg.n_layers % per else 0)
    ctx.overrides["model"] = model
    return ctx


def run(ctx, control: bool = False):
    """(result, checks) of one run of the cell (with ``control``, the
    float8 control judged in the program's place)."""
    return harness.execute(ctx, control=control)
