"""Fault-tolerant training loop.

Port of ``repro.train.loop``.  Wires together: data pipeline (exact
skip-ahead), checkpoint manager (atomic, auto-fallback), heartbeat +
straggler monitors, and the train step.  ``FailureInjector`` lets tests kill
the loop at a chosen step and verify bit-exact resume.  Reading the loss
with ``float`` waits for the step, as the reference's ``block_until_ready``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.ckpt import CheckpointManager
from repro_torch.ft import HeartbeatMonitor, StragglerDetector

from .step import TrainState


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    log_every: int = 10
    worker_name: str = "host0"


@dataclass
class FailureInjector:
    fail_at_step: Optional[int] = None
    fired: bool = False

    def maybe_fail(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected failure at step {step}")


def train_loop(
    step_fn: Callable,  # (state, batch) -> (state, metrics)
    state: TrainState,
    pipeline,  # DataPipeline
    ckpt: Optional[CheckpointManager] = None,
    cfg: LoopConfig = LoopConfig(total_steps=100),
    injector: Optional[FailureInjector] = None,
    on_metrics: Optional[Callable] = None,
) -> tuple[TrainState, list[dict]]:
    """Runs to total_steps; resumes from the latest checkpoint if present
    (the restored leaves land on ``state``'s devices and dtypes)."""
    start = 0
    if ckpt is not None:
        s, restored = ckpt.restore(state)
        if s is not None:
            state = restored
            start = s
            pipeline.seek(start)
    heartbeat = HeartbeatMonitor()
    straggler = StragglerDetector()
    history: list[dict] = []

    for step in range(start, cfg.total_steps):
        if injector is not None:
            injector.maybe_fail(step)
        t0 = time.perf_counter()
        _, batch = next(pipeline)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        heartbeat.beat(cfg.worker_name, step)
        straggler.observe(cfg.worker_name, dt)
        rec = {
            "step": step,
            "loss": loss,
            "grad_norm": float(metrics["grad_norm"]),
            "lr": float(metrics["lr"]),
            "step_time_s": dt,
        }
        history.append(rec)
        if on_metrics and step % cfg.log_every == 0:
            on_metrics(rec)
        if ckpt is not None and (step + 1) % cfg.ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt is not None:
        ckpt.save(cfg.total_steps, state)
    return state, history
