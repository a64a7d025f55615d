"""Atomic checkpoint manager.

Port of ``repro.ckpt.manager``, on the same disk format, so a checkpoint
written by either package restores in the other.  Layout per step::

    <dir>/step_000000123/
        manifest.json     # keys, shapes, dtypes, checksums, step
        arrays.npz        # flattened leaves (on the host)

Write protocol: write into ``.tmp-<step>`` then ``os.replace`` to the final
name — a crash mid-write never corrupts the latest checkpoint.  ``restore``
scans newest-first and skips manifests whose checksums fail (torn writes /
bitrot), falling back to the last good checkpoint.

A leaf's key is its path, written as ``jax.tree_util``'s key path prints
it: a dict key as itself, a NamedTuple field as ``.name``, a sequence index
as its number, joined by ``/``; dict keys are visited in sorted order.  A
``TrainState``'s keys are therefore the reference's: ``.params/embed``,
``.opt/.step``, ``.opt/.mu/embed`` ...  numpy has no bfloat16, so a bfloat16
leaf is stored as float32 (exact) and cast back on restore.

A sharded tree (each rank holding its shards, ``dist.shard_tree``) is saved
as global arrays, as the reference's host-gathered arrays: ``save(...,
shardings=)`` gathers it on every rank, rank 0 writes and the others wait
at a barrier.  ``restore(..., shardings=)`` reads the global arrays and
places each rank's shard by the new shardings, on the mesh's device, so a
checkpoint saved on one mesh resumes on another (``reshard.py``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import zipfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import gather_tree, shard_tree


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, prefix: tuple = ()) -> list:
    """[(key, leaf)] depth first, in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten_with_paths(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in _flatten_with_paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like, values):
    """A tree shaped as ``like`` whose leaves are taken from the iterator
    ``values`` in :func:`_flatten_with_paths` order."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], values) for k in sorted(like)}
        return {k: out[k] for k in like}  # keep like's own key order
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), values) for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, values) for v in like)
    return next(values)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             shardings: Any = None) -> Path:
        """Write ``tree`` as step ``step``.  With ``shardings`` (the tree's
        layouts), every rank of their mesh calls it with its shards."""
        if shardings is not None:
            tree = gather_tree(tree, shardings)
            if dist.get_rank() != 0:
                dist.barrier()
                return self.dir / f"step_{step:09d}"
            try:
                return self._write(step, tree, extra)
            finally:
                dist.barrier()
        return self._write(step, tree, extra)

    def _write(self, step: int, tree: Any, extra: Optional[dict]) -> Path:
        arrays = {k: _host(v) for k, v in _flatten_with_paths(tree)}
        manifest = {
            "step": step,
            "keys": list(arrays.keys()),
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
            "checksums": {k: _digest(a) for k, a in arrays.items()},
            "extra": extra or {},
        }
        tmp = self.dir / f".tmp-{step}"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def _verify(self, path: Path) -> Optional[dict]:
        """The manifest if every array's checksum holds, else None."""
        try:
            manifest = json.loads((path / "manifest.json").read_text())
            with np.load(path / "arrays.npz") as z:
                for k in manifest["keys"]:
                    if _digest(z[k]) != manifest["checksums"][k]:
                        return None
            return manifest
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):  # torn, missing or garbage files
            return None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> tuple[Optional[int], Any]:
        """Restore into the structure of ``like``, a tree of tensors (or of
        ``meta`` tensors) of the global shapes.  Each leaf comes back in its
        ``like`` leaf's dtype, on its device (the host for a ``meta`` leaf),
        or with ``shardings`` as this rank's shard on the mesh's device.
        Newest-first; corrupt checkpoints, and ones whose keys or shapes do
        not match ``like``, are skipped.  Returns (step, tree) or (None,
        None)."""
        candidates = self.steps()
        if step is not None:
            candidates = [s for s in candidates if s == step]
        leaves = _flatten_with_paths(like)
        for s in reversed(candidates):
            path = self.dir / f"step_{s:09d}"
            if self._verify(path) is None:
                continue
            with np.load(path / "arrays.npz") as z:
                if not all(key in z and tuple(z[key].shape) == tuple(leaf.shape)
                           for key, leaf in leaves):
                    continue
                vals = [self._place(z[key], leaf) for key, leaf in leaves]
            tree = _unflatten(like, iter(vals))
            if shardings is not None:
                tree = shard_tree(tree, shardings)
            return s, tree
        return None, None

    @staticmethod
    def _place(a: np.ndarray, leaf) -> torch.Tensor:
        dev = leaf.device if leaf.device.type != "meta" else torch.device("cpu")
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=leaf.dtype)

    def latest_manifest(self) -> Optional[dict]:
        for s in reversed(self.steps()):
            m = self._verify(self.dir / f"step_{s:09d}")
            if m:
                return m
        return None

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
