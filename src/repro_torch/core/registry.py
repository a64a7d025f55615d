"""Benchmark registry — paper-table benchmarks register here with metadata.

``repro_torch.bench`` re-exports :func:`register`; suites decorate a function that
returns ``list[BenchRecord]`` and declare which paper table/figure it
reproduces plus its quick/full sweep grids:

    @register("axpy", paper_ref="Fig 1.1",
              quick={"sizes": (1 << 18,)}, full={"sizes": (1 << 18, 1 << 22)})
    def bench_axpy(sizes=(1 << 18,)) -> list[BenchRecord]: ...

The runner looks benchmarks up here, picks the grid for the requested mode,
and calls the function with those keyword arguments.

Passing ``backends=("cuda", "torch")`` registers one *variant* per backend
(named ``name[backend]``, the paper's side-by-side comparison axis) instead
of the bare name.  Each variant runs its function under
``kernel_policy(backend=...)`` from :mod:`repro_torch.kernels.api`, passes
``backend=`` through when the function accepts it, and tags the emitted
record names with ``[backend]`` so a single results document holds every
hardware path of the same measurement.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field, replace
from typing import Callable, Optional


@dataclass(frozen=True)
class BenchSpec:
    """A registered benchmark plus its per-mode sweep grids."""

    name: str
    fn: Callable
    paper_ref: str = ""  # e.g. "Fig 1.1", "Tab 4.3"
    description: str = ""
    quick: dict = field(default_factory=dict)  # kwargs for quick mode
    full: dict = field(default_factory=dict)  # kwargs for full mode
    tags: tuple = ()
    backend: str = ""  # kernel backend for a parameterized variant

    def params(self, mode: str = "quick") -> dict:
        if mode not in ("quick", "full"):
            raise ValueError(f"mode must be quick|full, got {mode!r}")
        return dict(self.quick if mode == "quick" else self.full)

    def run(self, mode: str = "quick", overrides: Optional[dict] = None) -> list:
        kwargs = self.params(mode)
        if overrides:
            kwargs.update(overrides)
        if not self.backend:
            return self.fn(**kwargs)
        # backend variant: scope the kernel policy, thread the backend kwarg
        # through when accepted, and tag records with the variant identity.
        from repro_torch.kernels.api import kernel_policy

        if "backend" in inspect.signature(self.fn).parameters:
            kwargs.setdefault("backend", self.backend)
        with kernel_policy(backend=self.backend):
            recs = self.fn(**kwargs)
        tag = f"[{self.backend}]"
        return [
            replace(
                r,
                benchmark=self.name,
                name=r.name if r.name.endswith(tag) else r.name + tag,
            )
            for r in recs
        ]


_REGISTRY: dict[str, BenchSpec] = {}


def register(
    name: str,
    *,
    paper_ref: str = "",
    description: str = "",
    quick: Optional[dict] = None,
    full: Optional[dict] = None,
    tags: tuple = (),
    backends: tuple = (),
):
    """Decorator: register ``fn`` as benchmark ``name`` with its metadata.

    With ``backends``, registers one ``name[backend]`` variant per entry
    (and not the bare ``name``).
    """

    def deco(fn: Callable) -> Callable:
        doc_first = (fn.__doc__ or "").strip().splitlines()
        desc = description or (doc_first[0] if doc_first else "")
        variants = [(f"{name}[{b}]", b) for b in backends] if backends else [(name, "")]
        for vname, _ in variants:  # all-or-nothing: check before any insert
            if vname in _REGISTRY:
                raise ValueError(f"benchmark {vname!r} already registered")
        for vname, backend in variants:
            _REGISTRY[vname] = BenchSpec(
                name=vname,
                fn=fn,
                paper_ref=paper_ref,
                description=desc,
                quick=dict(quick or {}),
                full=dict(full if full is not None else quick or {}),
                tags=tuple(tags),
                backend=backend,
            )
        return fn

    return deco


def get(name: str) -> BenchSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown benchmark {name!r}; registered: {', '.join(names()) or '(none)'}"
        ) from None


def names() -> list[str]:
    return sorted(_REGISTRY)


def specs() -> list[BenchSpec]:
    return [_REGISTRY[n] for n in names()]


def unregister(name: str) -> None:
    """Remove a registration (test helper)."""
    _REGISTRY.pop(name, None)
