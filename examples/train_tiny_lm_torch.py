"""End-to-end training on the PyTorch port: a small qwen-family
model trained on the synthetic Zipf+structure stream, with checkpointing and
an injected failure + automatic resume mid-run (the fault-tolerance path
exercised for real).  The twin of ``examples/train_tiny_lm.py``; it runs on
the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/train_tiny_lm_torch.py [--steps 200] [--d-model 256]
    PYTHONPATH=src python examples/train_tiny_lm_torch.py --device cpu --steps 40

Pass --d-model 768 --layers 12 for the ~100M configuration.  ``main``
returns the resumed run's history; ``make_run`` gives the run's pieces, so a
caller can train the same run uninterrupted and compare.
"""
import argparse
import tempfile

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.timing import resolve_device
from repro_torch.data import DataPipeline, SyntheticLM
from repro_torch.models import build_model
from repro_torch.models.common import count_params
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.train.loop import FailureInjector, LoopConfig, train_loop
from repro_torch.train.step import TrainState, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails with no card visible) or cpu")
    return ap.parse_args(argv)


def make_run(args, dev):
    """The run's pieces: (step_fn, fresh_state, source) — ``fresh_state()``
    builds the seeded initial TrainState, so an uninterrupted run can be
    compared with a resumed one."""
    cfg = get_config("qwen2.5-14b").replace(
        name="tiny-lm",
        n_layers=args.layers,
        d_model=args.d_model,
        n_heads=max(args.d_model // 64, 2),
        n_kv_heads=max(args.d_model // 128, 2),
        head_dim=64,
        d_ff=args.d_model * 4,
        vocab_size=args.vocab,
        dtype="float32",
        param_dtype="float32",
        remat=False,
        attn_chunk=128,
    )
    model = build_model(cfg, device=dev)
    opt = AdamW(weight_decay=0.01)
    lr_fn = cosine_with_warmup(1e-3, warmup=args.steps // 10, total=args.steps)

    def fresh_state():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        return TrainState(params=params, opt=opt.init(params))

    source = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    return make_train_step(model.loss_fn, opt, lr_fn), fresh_state, source


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    step_fn, fresh_state, src = make_run(args, dev)
    state = fresh_state()
    print(f"tiny-lm: {count_params(state.params) / 1e6:.1f}M params on {dev}")

    pipeline = DataPipeline(lambda s: src.batch_at(s), device=dev, prefetch=2)

    try:
        with tempfile.TemporaryDirectory() as d:
            ckpt = CheckpointManager(d, keep=2)
            injector = FailureInjector(args.fail_at or args.steps // 2)
            loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=max(args.steps // 4, 10))
            try:
                train_loop(step_fn, state, pipeline, ckpt=ckpt, cfg=loop_cfg,
                           injector=injector,
                           on_metrics=lambda r: print(
                               f"step {r['step']:4d} loss {r['loss']:.4f} "
                               f"({r['step_time_s'] * 1e3:.0f} ms)"))
            except RuntimeError as e:
                print(f"!! {e} — resuming from last checkpoint")
            pipeline.seek(0)
            state, hist = train_loop(step_fn, state, pipeline, ckpt=ckpt, cfg=loop_cfg,
                                     on_metrics=lambda r: print(
                                         f"step {r['step']:4d} loss {r['loss']:.4f}"))
    finally:
        pipeline.close()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"done: loss {first:.4f} -> {last:.4f} over {args.steps} steps "
          f"(resumed at step {hist[0]['step']})")
    if not last < first:
        raise SystemExit("training must reduce loss")
    return hist


if __name__ == "__main__":
    main()
