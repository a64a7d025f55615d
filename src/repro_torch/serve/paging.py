"""Host-side KV page accounting: allocator, refcounts, shared prefixes.

Port of ``repro.serve.paging``: host code, ported whole.

The device side (``repro_torch.models.attention``) stores KV in one global pool of
fixed-size pages; everything *about* those pages — which are free, which lane
owns which, how many owners a shared page has — lives here, in plain Python,
off the device path.  The engine consults the allocator between ticks and
ships the resulting block tables to the device as int32 tensors.

Invariants the allocator maintains (and the engine relies on):

- a page id is handed out exactly once until every owner frees it
  (``refcount`` drops to 0),
- a page with ``refcount > 1`` is *shared* and must never be written —
  writers call :meth:`PageAllocator.is_shared` and copy first
  (copy-on-write, at page granularity),
- ``free`` is idempotent per owner (each ``free`` drops one reference).

>>> a = PageAllocator(n_pages=4, page_size=8)
>>> p = a.alloc(2)
>>> a.used, a.free_pages
(2, 2)
>>> a.share(p)            # a second owner: refcount 2 each
>>> a.is_shared(p[0])
True
>>> a.free(p)             # first owner releases; still held by the second
>>> a.used
2
>>> a.free(p)             # second owner releases; pool fully free again
>>> a.used
0
>>> a.alloc(5)
Traceback (most recent call last):
    ...
repro_torch.serve.paging.PagePoolExhausted: need 5 pages, 4 free (pool=4)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable


class PagePoolExhausted(RuntimeError):
    """Raised by :meth:`PageAllocator.alloc` when the pool cannot satisfy a
    request; the engine turns this into admission back-off or preemption."""


class PageAllocator:
    """Refcounted fixed-size page pool (host bookkeeping only).

    ``n_pages`` pages of ``page_size`` KV slots each.  Pages are identified
    by their pool index (0..n_pages-1).  Free pages are recycled LIFO, which
    keeps recently-touched pool regions hot.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: list[int] = list(range(n_pages - 1, -1, -1))  # pop() -> page 0 first
        self._refs: dict[int, int] = {}

    # -- queries -----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Pages with no owner."""
        return len(self._free)

    @property
    def used(self) -> int:
        """Pages with at least one owner."""
        return self.n_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def is_shared(self, page: int) -> bool:
        """True if writing ``page`` would corrupt another owner's view."""
        return self._refs.get(page, 0) > 1

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def pages_for(self, n_slots: int) -> int:
        """Pages needed to hold ``n_slots`` KV entries (ceil division)."""
        return -(-n_slots // self.page_size)

    # -- transitions -------------------------------------------------------
    def alloc(self, n: int = 1) -> list[int]:
        """Claim ``n`` fresh pages (refcount 1 each) or raise
        :class:`PagePoolExhausted` claiming none."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free (pool={self.n_pages})"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages: Iterable[int]) -> None:
        """Add one owner to each page (must currently be owned)."""
        for p in pages:
            if self._refs.get(p, 0) < 1:
                raise ValueError(f"page {p} is not allocated")
            self._refs[p] += 1

    def free(self, pages: Iterable[int]) -> None:
        """Drop one owner from each page; pages with no owners return to the
        pool.  Freeing an unallocated page is an error (double free)."""
        for p in pages:
            r = self._refs.get(p, 0)
            if r < 1:
                raise ValueError(f"double free of page {p}")
            if r == 1:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = r - 1


@dataclass
class SharedPrefix:
    """A registered common prompt prefix whose KV pages live in the pool.

    The registry (the engine) holds one permanent reference on every page, so
    prefix pages survive any session's exit; forking sessions take additional
    references on the pages they reuse.  ``tokens`` is the full registered
    prefix; a fork reuses KV for positions ``[0, len(tokens))`` except that at
    least the final prompt token is always re-fed so the fork has logits to
    sample from (see ``ServeEngine._fork_plan``).
    """

    tokens: tuple
    pages: list[int] = field(default_factory=list)
    hits: int = 0

    def __len__(self) -> int:
        return len(self.tokens)
