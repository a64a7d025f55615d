"""Meshes: named axes over ranks.

Port of ``repro.launch.mesh``, with the same shapes, axis names and
factorisation.  Single pod: 256 ranks as (data=16, model=16); multi-pod: a
leading ``pod`` axis.  The reference's mesh is a grid of devices driven by
one process; here it is a grid of ranks, one process each
(``torch.distributed``).

A :class:`Mesh` is first only a shape and axis names, so the sharding rules,
the tests and the dry run work in one process at any size, (2, 16, 16)
included.  :meth:`Mesh.bind`, called on every rank of a world of the mesh's
size, creates one process group per axis line and fixes this rank's
coordinates and device.  :meth:`Mesh.place` fixes one rank's coordinates
and device with no world and no process group: the dry run
(``launch/dryrun.py``) runs that rank's program on the ``meta`` device, its
collectives recorded, not sent (``dist.collectives.recording``).
``torch.distributed.device_mesh`` is not used: a
``DeviceMesh`` cannot exist without a process group, and its ``"cuda"``
meshes assume NCCL, which refuses two ranks on one GPU.
"""
from __future__ import annotations

from math import prod
from typing import Optional

import torch


class Mesh:
    """Named axes over ``prod(shape)`` ranks, row-major: rank r sits at
    ``numpy.unravel_index(r, shape)``, as ``jax.make_mesh`` lays devices."""

    def __init__(self, shape: tuple, axis_names: tuple):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} do not match")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = prod(self.shape.values())
        self.rank: Optional[int] = None
        self.device: Optional[torch.device] = None
        self._groups: dict = {}
        self._lines: dict = {}

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({dims}{'' if self.rank is None else f'; rank {self.rank}'})"

    # -- geometry ---------------------------------------------------------
    def coords(self, rank: int) -> dict:
        """{axis: index} of ``rank``."""
        out, rest = {}, rank
        for a in reversed(self.axis_names):
            out[a] = rest % self.shape[a]
            rest //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def _rank_of(self, coords: dict) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def line(self, rank: int, axis: str) -> list:
        """The ranks that share every coordinate of ``rank`` but ``axis``'s,
        in ``axis`` order."""
        c = self.coords(rank)
        return [self._rank_of({**c, axis: i}) for i in range(self.shape[axis])]

    # -- binding to a process group ---------------------------------------
    def bind(self, device: Optional[torch.device] = None) -> "Mesh":
        """Create this rank's process group on every axis.  Every rank of an
        initialised world of ``self.size`` ranks must call it, in the same
        order (``new_group`` is collective over the world).  ``device`` is
        where this rank's shards live (default: the CPU)."""
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() != self.size:
            world = dist.get_world_size() if dist.is_initialized() else None
            raise RuntimeError(f"{self!r} needs an initialised world of {self.size} ranks "
                               f"(world: {world})")
        self.rank = dist.get_rank()
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        for axis in self.axis_names:
            for ranks in sorted({tuple(self.line(r, axis)) for r in range(self.size)}):
                group = dist.new_group(list(ranks))
                if self.rank in ranks:
                    self._groups[axis], self._lines[axis] = group, list(ranks)
        return self

    def place(self, rank: int, device="meta") -> "Mesh":
        """Fix this mesh's rank and device with no process group (no world
        is needed): ``index`` and ``axis_ranks`` answer for ``rank``;
        ``group`` raises, so a collective runs only under
        ``dist.collectives.recording()``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on {self!r}")
        self.rank, self.device = rank, torch.device(device)
        self._groups = {}
        self._lines = {axis: self.line(rank, axis) for axis in self.axis_names}
        return self

    def group(self, axis: str):
        self._need_bound()
        if axis not in self._groups:
            raise RuntimeError(f"{self!r} was placed without a world: it has no process group "
                               "(record its collectives: dist.collectives.recording())")
        return self._groups[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        self._need_bound()
        return self.coords(self.rank)[axis]

    def axis_ranks(self, axis: str) -> list:
        """The global ranks of this rank's ``axis`` line."""
        self._need_bound()
        return self._lines[axis]

    def _need_bound(self) -> None:
        if self.rank is None:
            raise RuntimeError(f"{self!r} is abstract: call bind() on every rank first "
                               "(or place() one rank)")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(*, multi_pod: bool = False) -> Mesh:
    """Small mesh for CI-size integration tests (8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh_for(devices: int, model_parallel: int, pods: int = 1) -> Mesh:
    """Elastic-scaling helper: any (pods, data, model) factorization."""
    per_pod = devices // pods
    data = per_pod // model_parallel
    assert pods * data * model_parallel == devices, (devices, model_parallel, pods)
    if pods > 1:
        return Mesh((pods, data, model_parallel), ("pod", "data", "model"))
    return Mesh((data, model_parallel), ("data", "model"))
