"""Run functions on N local ranks, one process each.

The port's counterpart of the reference's fake devices
(``XLA_FLAGS=--xla_force_host_platform_device_count``): the reference runs
a mesh in one process; SPMD on ``torch.distributed`` needs a process per
rank.  ``run_ranks(fn, n, *args)`` starts ``n`` processes by ``spawn`` (a
parent that has initialised CUDA cannot fork), joins them in one world
through a ``FileStore`` in a fresh temporary directory (no fixed port, so
concurrent runs never meet), calls ``fn(rank, *args)`` on each and returns
the results in rank order.  The process group and the join both time out; a
rank that raises or hangs makes the call raise, after every rank is gone.
:class:`RankGroup` keeps its ranks between calls: it starts them once and
sends them commands until it is closed (a tensor-parallel serving replica's
ranks, ``serve/replica_group.py``).

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
import weakref
from typing import Callable, Optional

import torch

from repro_torch.core.timing import NoCudaDeviceError

BACKENDS = ("gloo", "nccl")


def choose_backend(devices) -> str:
    """NCCL when every rank's device is a CUDA device of its own, else gloo
    (ranks that share a GPU, or run on the CPU)."""
    devices = [torch.device(d) for d in devices]
    distinct = len({(d.type, d.index) for d in devices}) == len(devices)
    return "nccl" if distinct and all(d.type == "cuda" for d in devices) else "gloo"


def rank_device(device: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, or GPU ``rank`` modulo the count
    (ranks share the GPUs in turn)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


_STATE: dict = {}  # a rank process's own, kept between its group's commands
_DEVICE: list = []  # a rank process's device


def rank_state() -> dict:
    """In a rank of a :class:`RankGroup`: a dict the group's commands keep
    between calls (cleared when the group closes)."""
    return _STATE


def this_device() -> torch.device:
    """In a rank: the device it was started on."""
    return _DEVICE[0]


def _serve(rank: int, n: int, store_path: str, backend: str, device: str, timeout_s: float,
           commands, results) -> None:
    """A rank's life: join the world, then run each command ``(seq, fn,
    args)`` as ``fn(rank, *args)`` and report it, until ``None`` comes."""
    import torch.distributed as dist

    if backend == "gloo":  # the ranks are on this host: talk over the loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        dev = torch.device(device)
        _DEVICE[:] = [dev]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=rank,
                                world_size=n, timeout=datetime.timedelta(seconds=timeout_s),
                                **kw)
    except Exception:  # reported to the parent, which raises it
        results.put((0, rank, "error", traceback.format_exc()))
        return
    results.put((0, rank, "ok", None))
    try:
        while (cmd := commands.get()) is not None:
            seq, fn, args = cmd
            try:
                out = ("ok", pickle.dumps(fn(rank, *args)))
            except Exception:
                out = ("error", traceback.format_exc())
            del cmd, args
            results.put((seq, rank, *out))
    finally:
        _STATE.clear()
        dist.destroy_process_group()


def _stop(procs: list, commands: list, results, tmp, grace: float) -> None:
    """Ask every rank to stop, then kill what is left; free the queues and
    the rendezvous directory."""
    for q in commands:
        try:
            q.put(None)
        except (ValueError, OSError):  # already closed
            pass
    for p in procs:
        p.join(timeout=grace)
        if p.is_alive():
            p.kill()
            p.join(timeout=5.0)
    for q in (*commands, results):
        q.close()
        q.join_thread()
    tmp.cleanup()


class RankGroup:
    """``n`` ranks started once, one process each, joined in one world, that
    run the commands sent to them until :meth:`close`.

    The rules of :func:`run_ranks` hold: the ranks start by ``spawn`` and
    meet through a ``FileStore`` in a fresh temporary directory; the process
    group and every command time out; a rank that raises or hangs makes the
    call raise (every failing rank's traceback, or ``TimeoutError``) after
    every rank is gone, and the group is then closed (:attr:`closed`).
    ``devices`` gives each rank its device (default: :func:`rank_device` of
    ``device``); the backend defaults to :func:`choose_backend`.  The ranks
    run on the card unless the caller asks for the CPU.  A command
    ``fn(rank, *args)`` must be a module-level function; its arguments go
    through ``multiprocessing``'s pickler (tensors shared, not copied: CUDA
    tensors by CUDA IPC, host tensors through shared memory), its result
    through ``pickle``.  :func:`rank_state` keeps a rank's state between
    commands.
    """

    def __init__(self, n: int, *, devices: Optional[list] = None, backend: Optional[str] = None,
                 device: str = "cuda", timeout: float = 600.0):
        import multiprocessing as mp

        asked = [torch.device(d) for d in (devices or [device])]
        if any(d.type == "cuda" for d in asked) and not torch.cuda.is_available():
            raise NoCudaDeviceError("no CUDA device is visible; pass device='cpu' to run the "
                                    "ranks on the host")
        devices = asked if devices else [rank_device(device, r) for r in range(n)]
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} ranks")
        backend = backend or choose_backend(devices)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
        self.n, self.backend, self.timeout = n, backend, timeout
        self.devices = devices
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._commands = [ctx.Queue() for _ in range(n)]
        self._tmp = tempfile.TemporaryDirectory(prefix="repro_ranks_")
        store = os.path.join(self._tmp.name, "store")
        self._procs = [ctx.Process(target=_serve, daemon=True,
                                   args=(r, n, store, backend, str(devices[r]), timeout,
                                         self._commands[r], self._results))
                       for r in range(n)]
        self._seq = 0
        self._closed = False
        self._finalizer = weakref.finalize(self, _stop, self._procs, self._commands,
                                           self._results, self._tmp, 0.5)
        for p in self._procs:
            p.start()
        self._collect(0, timeout)

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def closed(self) -> bool:
        """Whether the ranks are gone: closed by the caller, or after a
        failed call."""
        return self._closed

    def call(self, fn: Callable, *args, timeout: Optional[float] = None) -> list:
        """``[fn(0, *args), ..., fn(n - 1, *args)]``, each on its rank."""
        if self._closed:
            raise RuntimeError("the rank group is closed")
        self._seq += 1
        for q in self._commands:
            q.put((self._seq, fn, args))
        return self._collect(self._seq, self.timeout if timeout is None else timeout)

    def close(self, grace: float = 5.0) -> None:
        """Stop every rank (killing one that does not stop within ``grace``
        seconds)."""
        if not self._closed:
            self._closed = True
            self._finalizer.detach()
            _stop(self._procs, self._commands, self._results, self._tmp, grace)

    def _collect(self, seq: int, timeout: float) -> list:
        """Every rank's result of command ``seq`` (0: the start), or raise
        after closing the group."""
        n, got, error, dead_since = self.n, {}, None, None
        deadline = time.monotonic() + timeout
        while len(got) < n and error is None:
            try:
                s, rank, status, payload = self._results.get(timeout=1.0)
            except queue.Empty:
                now = time.monotonic()
                if now > deadline:
                    self.close(grace=0.5)
                    raise TimeoutError(f"{n - len(got)} of {n} ranks did not finish in "
                                       f"{timeout} s") from None
                dead = [r for r, p in enumerate(self._procs)
                        if r not in got and p.exitcode is not None]
                dead_since = (dead_since or now) if dead else None
                if dead and now - dead_since > 3.0:  # its result would be here by now
                    error = f"rank {dead[0]} exited {self._procs[dead[0]].exitcode} with no result"
                continue
            if status == "ok" and s == seq:
                got[rank] = None if payload is None else pickle.loads(payload)
            elif status != "ok":
                error = f"rank {rank} failed:\n{payload}"
        if error is not None:  # the other ranks' reports too: the first may be an echo
            errors, grace = [error], time.monotonic() + 3.0
            while len(got) + len(errors) < n and time.monotonic() < grace:
                try:
                    _, rank, status, payload = self._results.get(timeout=0.5)
                except queue.Empty:
                    continue
                if status != "ok":
                    errors.append(f"rank {rank} failed:\n{payload}")
            self.close(grace=0.5)
            raise RuntimeError("\n".join(sorted(errors)))
        return [got[r] for r in range(n)]


def run_ranks(fn: Callable, n: int, *args, backend: Optional[str] = None, device: str = "cuda",
              timeout: float = 600.0) -> list:
    """``[fn(0, *args), ..., fn(n - 1, *args)]``, each on its own rank of
    one world: a :class:`RankGroup` that runs one command.  ``fn`` and
    ``args`` must pickle (a module-level function); so must each result.
    ``device`` is "cpu" or "cuda"; ``backend`` defaults to
    :func:`choose_backend`.  Raises ``RuntimeError`` with every failing
    rank's traceback (a rank's failure makes its peers' collectives fail
    too), or ``TimeoutError`` after ``timeout`` seconds (to start, then to
    run); ``NoCudaDeviceError`` when ``device`` is "cuda" and no card is
    visible."""
    with RankGroup(n, backend=backend, device=device, timeout=timeout) as group:
        return group.call(fn, *args)
