"""Persisted autotune cache for the kernel dispatch layer.

The paper's workflow is: microbenchmark the hardware once, distill the
findings into a model, then let the model drive tile/layout choices forever
after.  ``TuningCache`` is the "forever after" part: tile choices computed by
:mod:`repro_torch.core.autotune` are memoized under a key of
``(op, shape signature, dtype, backend)`` and optionally persisted to a JSON
file so later processes skip the search.

The cache is deliberately dumb — a flat ``{key: {tile kwarg: int}}`` table —
so the JSON file is hand-inspectable and diffs cleanly in review.  Set the
``REPRO_TORCH_TUNING_CACHE`` environment variable (or call :func:`configure`) to
enable persistence; by default the cache is in-memory only, which keeps unit
tests and CI hermetic.  The variable is the port's own, not the reference's
``REPRO_TUNING_CACHE``: the two packages' keys name different backends, so
they never share a file.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

__all__ = ["ENV_VAR", "TuningCache", "configure", "get_cache", "make_key", "shape_signature"]

ENV_VAR = "REPRO_TORCH_TUNING_CACHE"


def shape_signature(args) -> str:
    """Stable signature of the tensor arguments: ``float32[128,256];float32[256,64]``
    (the dtype as the reference's numpy name, without torch's prefix)."""
    parts = []
    for a in args:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is None or dtype is None:
            continue  # scalars/python values don't affect tiling
        name = str(dtype).removeprefix("torch.")
        parts.append(f"{name}[{','.join(str(d) for d in shape)}]")
    return ";".join(parts)


def make_key(op: str, args, backend: str) -> str:
    return f"{op}|{backend}|{shape_signature(args)}"


class TuningCache:
    """Flat tile-choice store with hit/miss counters and JSON persistence."""

    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        self.entries: dict = {}
        self.hits = 0
        self.misses = 0
        if self.path is not None and self.path.exists():
            self.load(self.path)

    # -- lookup/store -------------------------------------------------------
    def lookup(self, key: str) -> Optional[dict]:
        entry = self.entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        return dict(entry)

    def store(self, key: str, tiles: dict) -> None:
        self.entries[key] = {k: int(v) for k, v in tiles.items()}
        if self.path is not None:
            self.save(self.path)

    def __len__(self) -> int:
        return len(self.entries)

    # -- persistence --------------------------------------------------------
    def save(self, path) -> None:
        """Merge-then-replace: re-read entries persisted by other processes
        (ours win on key conflict), then write via a temp file + os.replace
        so concurrent readers never observe a half-written document."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        if p.exists():
            try:
                self.load(p, theirs_win=False)
            except (ValueError, json.JSONDecodeError):
                pass  # corrupt/foreign file: overwrite with our entries
        tmp = p.with_name(f"{p.name}.tmp{os.getpid()}")
        tmp.write_text(json.dumps({"version": 1, "entries": self.entries}, indent=2) + "\n")
        os.replace(tmp, p)

    def load(self, path, theirs_win: bool = True) -> None:
        doc = json.loads(Path(path).read_text())
        if doc.get("version") != 1:
            raise ValueError(f"{path}: unsupported tuning-cache version {doc.get('version')}")
        theirs = doc.get("entries", {})
        if theirs_win:
            self.entries.update(theirs)
        else:
            self.entries = {**theirs, **self.entries}


# ---------------------------------------------------------------------------
# process-wide singleton (the dispatch layer's default cache)
# ---------------------------------------------------------------------------
_CACHE: Optional[TuningCache] = None


def get_cache() -> TuningCache:
    global _CACHE
    if _CACHE is None:
        _CACHE = TuningCache(path=os.environ.get(ENV_VAR) or None)
    return _CACHE


def configure(path: Optional[str] = None) -> TuningCache:
    """Replace the process-wide cache (tests; opting into persistence)."""
    global _CACHE
    _CACHE = TuningCache(path=path)
    return _CACHE
