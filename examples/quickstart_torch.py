"""Quickstart on the PyTorch port: the paper's workflow end to end on one
card.  The twin of ``examples/quickstart.py``; it runs on the card unless
``--device cpu`` is given.

1. Dissect the hardware you are on (pointer-chase + bandwidth + GEMM probes
   -> fitted HardwareModel; the paper's Ch. 3/4 in one call).
2. Use the H100's model to pick matmul tiles (the paper's Ch. 1 lesson).
3. Spin up a reduced assigned architecture, take one training step, decode.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.autotune import choose_matmul_tiles
from repro_torch.core.dissect import dissect_measure
from repro_torch.core.timing import resolve_device
from repro_torch.hw import H100
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.train.step import value_and_grad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails with no card visible) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # no card and no --device cpu: fail before measuring

    # --- 1. dissect ---------------------------------------------------
    print(f"== dissecting {dev} (quick probes) ==")
    rep = dissect_measure(quick=True, device=args.device)
    for lat, cap in rep.detected_levels:
        cap_s = f"{cap >> 10} KiB" if cap else "(last level)"
        print(f"  level: {lat:7.2f} ns/load  capacity {cap_s}")
    print(f"  stream bandwidth: {rep.hardware.main_memory_Bps / 1e9:.1f} GB/s")

    print(f"== {H100.name} model (the card's datasheet record) ==")
    for lvl in H100.levels:
        print(f"  {lvl.name}: {lvl.size_bytes >> 10} KiB, {lvl.latency_ns:.0f} ns, "
              f"{lvl.bandwidth_Bps / 1e9:.0f} GB/s")

    # --- 2. knowledge -> optimization ---------------------------------
    tile = choose_matmul_tiles(4096, 4096, 4096, "bfloat16", hw=H100)
    print(f"== autotuned tiles for 4096^3 bf16 matmul on {H100.name}: "
          f"({tile.bm},{tile.bk},{tile.bn}), predicted {tile.predicted_s * 1e6:.0f} us ==")

    # --- 3. a reduced assigned arch -----------------------------------
    cfg = get_config("qwen2.5-14b").reduced()
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device=dev),
        "targets": torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device=dev),
    }
    loss, grads = value_and_grad(model.loss_fn, params, batch)
    with torch.no_grad():
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.sub_(0.05 * g)
        loss2 = model.loss_fn(params, batch)
    print(f"== {cfg.name}: loss {float(loss):.4f} -> {float(loss2):.4f} after one step ==")

    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": batch["tokens"]}, 96)
        tok = logits.argmax(-1)
        logits, cache = model.decode_step(params, cache, tok,
                                          torch.full((2,), 64, dtype=torch.int32, device=dev))
    print(f"== decoded one token per sequence: {logits.argmax(-1).tolist()} ==")
    return float(loss), float(loss2)


if __name__ == "__main__":
    main()
