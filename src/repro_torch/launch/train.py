"""Training launcher.

Port of ``repro.launch.train``, with its flags and printed lines, plus
``--device``: ``cuda`` (the default; with no card visible the launcher exits
non-zero and never falls back to the host) or ``cpu``.  The weights are
random, from a generator seeded with ``--seed`` on the model's device; the
data is :class:`~repro_torch.data.SyntheticLM` from the same seed.  Use
``--reduced`` to train a smoke-size variant of any arch, or
``examples/train_tiny_lm_torch.py`` for the end-to-end run with an injected
failure and resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --reduced \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 2 --batch 2 --seq 512
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.timing import NoCudaDeviceError, resolve_device
from repro_torch.data import DataPipeline, SyntheticLM
from repro_torch.models import build_model
from repro_torch.models.common import count_params
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.train.loop import FailureInjector, LoopConfig, train_loop
from repro_torch.train.step import TrainState, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero with no card visible) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None, help="inject a failure (FT demo)")
    args = ap.parse_args(argv)

    try:
        dev = resolve_device(args.device)
    except NoCudaDeviceError as e:
        raise SystemExit(str(e)) from None
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(train_microbatches=args.microbatches)

    model = build_model(cfg, device=dev)
    opt = AdamW()
    lr_fn = cosine_with_warmup(args.lr, warmup=max(args.steps // 20, 1), total=args.steps)
    step_fn = make_train_step(model.loss_fn, opt, lr_fn, microbatches=cfg.train_microbatches)

    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    state = TrainState(params=params, opt=opt.init(params))
    print(f"{cfg.name}: {count_params(params)/1e6:.2f}M params")

    source = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)

    def batch_fn(step):
        b = source.batch_at(step)
        if cfg.family in ("vlm", "encdec"):
            b["frontend"] = np.zeros((args.batch, cfg.frontend_len, cfg.d_model), np.float32)
        return b

    pipeline = DataPipeline(batch_fn, device=dev, prefetch=2)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    injector = FailureInjector(args.fail_at) if args.fail_at else None

    try:
        state, history = train_loop(
            step_fn,
            state,
            pipeline,
            ckpt=ckpt,
            cfg=LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every),
            injector=injector,
            on_metrics=lambda r: print(
                f"step {r['step']:5d}  loss {r['loss']:.4f}  |g| {r['grad_norm']:.3f}  "
                f"{r['step_time_s']*1e3:.0f} ms"
            ),
        )
    finally:
        pipeline.close()
    print(f"final loss {history[-1]['loss']:.4f} (first {history[0]['loss']:.4f})")
    return history


if __name__ == "__main__":
    main()
