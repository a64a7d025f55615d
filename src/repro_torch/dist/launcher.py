"""Run a function on N local ranks, one process each.

The port's counterpart of the reference's fake devices
(``XLA_FLAGS=--xla_force_host_platform_device_count``): the reference runs
a mesh in one process; SPMD on ``torch.distributed`` needs a process per
rank.  ``run_ranks(fn, n, *args)`` starts ``n`` processes by ``spawn`` (a
parent that has initialised CUDA cannot fork), joins them in one world
through a ``FileStore`` in a fresh temporary directory (no fixed port, so
concurrent runs never meet), calls ``fn(rank, *args)`` on each and returns
the results in rank order.  The process group and the join both time out; a
rank that raises or hangs makes the call raise, after every rank is gone.

The backend is stated, never switched: NCCL when every rank has a GPU of
its own, gloo when ranks share one GPU or run on the CPU
(:func:`choose_backend`).  NCCL refuses two ranks on one GPU.  The ranks run
on the card unless the caller asks for the CPU; with no card visible the
call raises ``NoCudaDeviceError`` before any rank starts.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch

from repro_torch.core.timing import NoCudaDeviceError

BACKENDS = ("gloo", "nccl")


def choose_backend(device: str, n: int) -> str:
    """NCCL when the ranks are on CUDA with a GPU each, else gloo."""
    if torch.device(device).type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, or GPU ``rank`` modulo the count
    (ranks share the GPUs in turn)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _worker(rank: int, n: int, store_path: str, backend: str, device: str, timeout_s: float,
            fn: Callable, args: tuple, results) -> None:
    import torch.distributed as dist

    if backend == "gloo":  # the ranks are on this host: talk over the loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=rank,
                                world_size=n, timeout=datetime.timedelta(seconds=timeout_s),
                                **kw)
        try:
            out = ("ok", pickle.dumps(fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises it
        out = ("error", traceback.format_exc())
    results.put((rank, *out))


def run_ranks(fn: Callable, n: int, *args, backend: Optional[str] = None, device: str = "cuda",
              timeout: float = 600.0) -> list:
    """``[fn(0, *args), ..., fn(n - 1, *args)]``, each on its own rank of
    one world.  ``fn`` and ``args`` must pickle (a module-level function);
    so must each result.  ``device`` is "cpu" or "cuda"; ``backend``
    defaults to :func:`choose_backend`.  Raises ``RuntimeError`` with every
    failing rank's traceback (a rank's failure makes its peers' collectives
    fail too), or ``TimeoutError`` after ``timeout`` seconds;
    ``NoCudaDeviceError`` when ``device`` is "cuda" and no card is visible."""
    import multiprocessing as mp

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError("no CUDA device is visible; pass device='cpu' to run the ranks "
                                "on the host")

    backend = backend or choose_backend(device, n)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(r, n, store, backend, device, timeout, fn, args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got, error, dead_since = {}, None, None
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n and error is None:
                try:
                    rank, status, payload = results.get(timeout=1.0)
                except queue.Empty:
                    now = time.monotonic()
                    if now > deadline:
                        raise TimeoutError(f"{n - len(got)} of {n} ranks did not finish in "
                                           f"{timeout} s") from None
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    dead_since = (dead_since or now) if dead else None
                    if dead and now - dead_since > 3.0:  # its result would be here by now
                        error = f"rank {dead[0]} exited {procs[dead[0]].exitcode} with no result"
                    continue
                if status == "ok":
                    got[rank] = pickle.loads(payload)
                else:
                    error = f"rank {rank} failed:\n{payload}"
            if error is not None:  # the other ranks' reports too: the first may be an echo
                errors, grace = [error], time.monotonic() + 3.0
                while len(got) + len(errors) < n and time.monotonic() < grace:
                    try:
                        rank, status, payload = results.get(timeout=0.5)
                    except queue.Empty:
                        continue
                    if status != "ok":
                        errors.append(f"rank {rank} failed:\n{payload}")
                error = "\n".join(sorted(errors))
        finally:
            for p in procs:
                p.join(timeout=5.0 if error is None else 0.5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)
            results.close()
        if error is not None:
            raise RuntimeError(error)
    return [got[r] for r in range(n)]
