"""Host-side data pipeline: background prefetch + device placement.

Port of ``repro.data.pipeline``.  Where the reference places each batch
against a ``NamedSharding``, this one takes a ``device``:

- double-buffered prefetch thread (depth configurable; 0 produces each batch
  on the caller's thread),
- per-batch placement on ``device``: on a CUDA device each array goes
  through pinned host memory and a non-blocking copy, so the prefetch thread
  overlaps the transfer with the step in flight,
- ``seek(step)`` for exact restart after failure (counter-mode source).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import timing


class DataPipeline:
    def __init__(
        self,
        batch_fn: Callable[[int], dict],  # step -> host batch (numpy arrays)
        device=None,  # where batches go (None: numpy arrays, unplaced)
        prefetch: int = 2,
        start_step: int = 0,
    ):
        self._batch_fn = batch_fn
        self._device = None if device is None else torch.device(device)
        self._step = start_step
        self._prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if prefetch > 0:
            self._start_thread()

    # ------------------------------------------------------------------
    def _place(self, v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _produce(self, step: int) -> dict:
        batch = self._batch_fn(step)
        if self._device is not None:
            batch = {k: self._place(v) for k, v in batch.items()}
        return batch

    def _start_thread(self):
        self._q = queue.Queue(maxsize=self._prefetch)
        self._stop.clear()

        def worker(start: int):
            s = start
            while not self._stop.is_set():
                try:
                    item = (s, self._produce(s))
                except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
                    self._q.put(("error", e))
                    return
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        self._thread = threading.Thread(target=worker, args=(self._step,), daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def __next__(self) -> tuple[int, dict]:
        if self._q is None:
            step = self._step
            self._step += 1
            return step, self._produce(step)
        with timing.span("pipeline.wait"):
            item = self._q.get()
        if item[0] == "error":
            raise item[1]
        self._step = item[0] + 1
        return item

    def __iter__(self):
        return self

    def seek(self, step: int):
        """Exact restart: next batch returned is for ``step``."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            while self._q is not None and not self._q.empty():
                self._q.get_nowait()
        self._step = step
        if self._prefetch > 0:
            self._start_thread()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
