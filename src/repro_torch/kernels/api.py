"""Unified kernel dispatch API: op registry, backends, and kernel policy.

The paper's core method is running the *same* operation through different
hardware paths and comparing them quantitatively.  As in ``repro.kernels.api``,
every kernel is a registered :class:`KernelOp` with named **backends**:

  * ``"cuda"``  the hand-written Hopper kernel (``csrc/*.cu``); it needs CUDA
                tensors,
  * ``"torch"`` the plain PyTorch version from :mod:`repro_torch.kernels.ref`,
                bound to the *same natural argument layout* — the oracle, on
                any device.

When neither the call nor the policy names a backend, the tensors decide: a
CUDA tensor dispatches to ``"cuda"``, a CPU tensor to ``"torch"``.  Asking for
``"cuda"`` with CPU tensors raises, and so does ``"cuda"`` for an op whose
kernel is not ported yet.

A context-local :func:`kernel_policy` scopes the backend and tile overrides::

    with kernel_policy(backend="torch", tiles={"matmul": {"bm": 64}}):
        y = api.matmul(a, b)

Tile kwargs resolve as: explicit kwarg > ``policy.tiles[op]`` > the
implementation's defaults.  Autotuned tiles and the numerics guard wait for
the port of ``core/autotune.py`` and ``kernels/guard.py``.
"""
from __future__ import annotations

import inspect
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

import torch

from . import axpy as _axpy
from . import matmul as _mm
from . import membw as _bw
from . import pchase as _pc
from . import ref
from ._util import fit_block, flatten_heads, flatten_ssm, pad_to_multiple, unflatten_heads

BACKENDS = ("cuda", "torch")


def default_backend(device) -> str:
    """The backend used when neither the call nor the policy names one."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _args_device(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class KernelPolicy:
    """Context-local kernel dispatch settings.

    ``backend`` of None defers to :func:`default_backend`; ``tiles`` maps op
    name -> tile-kwarg overrides (e.g. ``{"matmul": {"bm": 256}}``) and is
    merged across nested policies.
    """

    backend: Optional[str] = None
    tiles: dict = field(default_factory=dict)


_POLICY: ContextVar[KernelPolicy] = ContextVar("kernel_policy", default=KernelPolicy())


def current_policy() -> KernelPolicy:
    return _POLICY.get()


@contextmanager
def kernel_policy(backend: Optional[str] = None, autotune: Optional[bool] = None,
                  tiles: Optional[dict] = None, guard: Optional[str] = None):
    """Scoped policy override; unspecified fields inherit from the enclosing
    policy, and the previous policy is restored on exit (exception-safe)."""
    if autotune:
        raise NotImplementedError("autotune=True waits for the port of core/autotune.py")
    if guard not in (None, "off"):
        raise NotImplementedError(f"guard={guard!r} waits for the port of kernels/guard.py")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    outer = _POLICY.get()
    merged_tiles = dict(outer.tiles)
    for op_name, ov in (tiles or {}).items():
        op = _OPS.get(op_name)
        if op is None:
            raise ValueError(
                f"tiles override for unknown op {op_name!r}; registered: {op_names()}"
            )
        bad = sorted(set(ov) - set(op.tile_args))
        if bad:
            raise ValueError(
                f"op {op_name!r} has no tile kwarg(s) {bad}; tile args: {list(op.tile_args)}"
            )
        merged_tiles[op_name] = {**merged_tiles.get(op_name, {}), **ov}
    pol = KernelPolicy(
        backend=outer.backend if backend is None else backend, tiles=merged_tiles
    )
    token = _POLICY.set(pol)
    try:
        yield pol
    finally:
        _POLICY.reset(token)


def resolve_backend(requested: Optional[str] = None, device="cpu") -> str:
    """The backend a call on tensors of ``device`` would dispatch to."""
    return requested or current_policy().backend or default_backend(device)


# ---------------------------------------------------------------------------
# op registry
# ---------------------------------------------------------------------------
class KernelOp:
    """One registered operation with per-backend implementations.

    Calling the op dispatches through the current :class:`KernelPolicy`;
    ``backend=`` overrides the policy for a single call.  Tile kwargs are
    resolved as: explicit kwarg > policy.tiles[op] > the implementation's
    defaults, and reach only the ``cuda`` backend.
    """

    def __init__(self, name: str, tile_args: tuple = (), doc: str = ""):
        self.name = name
        self.tile_args = tuple(tile_args)
        self.__doc__ = doc
        self._impls: dict = {}
        self._accepts: dict = {}  # backend -> frozenset of kwarg names
        self._all_accepts: frozenset = frozenset()  # union across backends

    def bind(self, backend: str, fn: Callable) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"op {self.name!r} does not declare backend {backend!r}")
        self._impls[backend] = fn
        sig = inspect.signature(fn)
        self._accepts[backend] = frozenset(
            p.name for p in sig.parameters.values()
            if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)
        )
        self._all_accepts = self._all_accepts | self._accepts[backend]

    def defbackend(self, backend: str):
        """Decorator registering ``fn`` as this op's ``backend`` impl."""

        def deco(fn: Callable) -> Callable:
            self.bind(backend, fn)
            return fn

        return deco

    def impl(self, backend: str) -> Callable:
        try:
            return self._impls[backend]
        except KeyError:
            if backend == "cuda":
                raise NotImplementedError(
                    f"op {self.name!r} has no CUDA kernel yet (queued in ROADMAP.md); "
                    "use backend='torch'"
                ) from None
            bound = sorted(self._impls)
            raise KeyError(
                f"op {self.name!r} has no backend {backend!r} (bound: {bound})"
            ) from None

    # -- dispatch -----------------------------------------------------------
    def _resolve_tiles(self, pol: KernelPolicy, kwargs) -> dict:
        out = dict(kwargs)
        for k, v in pol.tiles.get(self.name, {}).items():
            if k in self.tile_args:
                out.setdefault(k, v)
        return out

    def bound(self, *args, backend: Optional[str] = None, **kwargs) -> Callable:
        """Resolve dispatch (backend, tiles, kwarg filtering) for these
        ``args`` once and return the impl partially applied with the final
        kwargs — timing loops call the result directly, keeping Python
        dispatch out of the measured path."""
        pol = current_policy()
        device = _args_device(args)
        be = resolve_backend(backend, device)
        if be not in BACKENDS:
            raise ValueError(f"unknown backend {be!r}; expected one of {BACKENDS}")
        if be == "cuda" and device.type != "cuda":
            raise ValueError(
                f"op {self.name!r}: backend 'cuda' runs the hand kernel and needs CUDA "
                f"tensors, got tensors on {device}; use backend='torch' on the CPU"
            )
        impl = self.impl(be)
        # a kwarg no backend understands is a caller bug, not a backend
        # difference — raise instead of silently running with defaults
        unknown = sorted(set(kwargs) - self._all_accepts)
        if unknown:
            raise TypeError(
                f"op {self.name!r} got unexpected keyword argument(s) {unknown}; "
                f"accepted across backends: {sorted(self._all_accepts)}"
            )
        if be == "cuda":
            kwargs = self._resolve_tiles(pol, kwargs)
        accepts = self._accepts[be]
        kwargs = {k: v for k, v in kwargs.items() if k in accepts}
        return partial(impl, **kwargs)

    def __call__(self, *args, backend: Optional[str] = None, **kwargs):
        return self.bound(*args, backend=backend, **kwargs)(*args)

    def __repr__(self) -> str:
        return f"KernelOp({self.name!r}, backends={sorted(self._impls)})"


_OPS: dict[str, KernelOp] = {}


def _register(op: KernelOp) -> KernelOp:
    if op.name in _OPS:
        raise ValueError(f"kernel op {op.name!r} already registered")
    _OPS[op.name] = op
    return op


def kernel_op(name: str, *, tile_args: tuple = ()):
    """Register the decorated function as op ``name``'s ``cuda`` implementation
    and return the :class:`KernelOp` dispatcher.  Bind further backends with
    ``@<op>.defbackend("torch")``."""

    def deco(cuda_fn: Callable) -> KernelOp:
        op = KernelOp(name, tile_args, doc=(cuda_fn.__doc__ or ""))
        op.bind("cuda", cuda_fn)
        return _register(op)

    return deco


def plain_op(name: str, *, tile_args: tuple = (), doc: str = "") -> KernelOp:
    """Register op ``name`` whose hand kernel is not ported yet: only its
    ``torch`` backend is bound, and ``cuda`` raises."""
    return _register(KernelOp(name, tile_args, doc=doc))


def get_op(name: str) -> KernelOp:
    try:
        return _OPS[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel op {name!r}; registered: {', '.join(op_names())}"
        ) from None


def op_names() -> list:
    return sorted(_OPS)


# ---------------------------------------------------------------------------
# ops — the cuda impls own padding/reshaping so callers pass natural layouts;
# the torch bindings accept the *same* layouts (backend interchangeability).
# ---------------------------------------------------------------------------
@kernel_op("axpy", tile_args=("block_rows", "block_cols", "vec_bytes"))
def axpy(x, y, alpha, *, block_rows=8, block_cols=512, vec_bytes=16):
    """alpha*x + y over (R, C) tiles — the Ch.1 access-width example."""
    return _axpy.axpy_cuda(
        x, y, alpha, block_rows=block_rows, block_cols=block_cols, vec_bytes=vec_bytes
    )


@axpy.defbackend("torch")
def _axpy_torch(x, y, alpha):
    return ref.axpy_ref(x, y, alpha)


stream_copy = plain_op(
    "stream_copy", tile_args=("block_rows", "block_cols"),
    doc="HBM->SM->HBM round-trip bandwidth probe.",
)


@stream_copy.defbackend("torch")
def _stream_copy_torch(x):
    return ref.copy_ref(x)


@kernel_op("stream_reduce", tile_args=("block_rows", "block_cols"))
def stream_reduce(x, *, block_rows=8, block_cols=512):
    """Read-bandwidth probe: (1,1) fp32 checksum of the streamed array."""
    return _bw.stream_reduce(x, block_rows=block_rows, block_cols=block_cols)


@stream_reduce.defbackend("torch")
def _stream_reduce_torch(x):
    return ref.reduce_ref(x)


strided_reduce = plain_op(
    "strided_reduce", tile_args=("block_rows",),
    doc="Sparse-access reduce probing load granularity (paper Tab 3.1).",
)


@strided_reduce.defbackend("torch")
def _strided_reduce_torch(x, *, stride):
    return ref.strided_reduce_ref(x, stride)


@kernel_op("pchase")
def pchase(perm, steps):
    """Dependent-load pointer chase; returns the final index as (1,1) int32."""
    return _pc.pchase_cuda(perm, steps)


pchase.defbackend("torch")(_pc.pchase_torch)


@kernel_op("matmul", tile_args=("bm", "bn", "bk"))
def matmul(a, b, *, bm=128, bn=128, bk=128, out_dtype=None):
    """Tiled matmul (the §4.4 GEMM-throughput probe target).  Inputs are
    zero-padded to (bm, bk, bn) multiples and the result sliced back, as in
    the reference; the kernel itself takes any shape."""
    m, k = a.shape
    _, n = b.shape
    bm, bk, bn = fit_block(bm, m), fit_block(bk, k), fit_block(bn, n)
    a = pad_to_multiple(pad_to_multiple(a, bm, 0), bk, 1)
    b = pad_to_multiple(pad_to_multiple(b, bk, 0), bn, 1)
    out = _mm.matmul_cuda(a, b, out_dtype=out_dtype)
    return out[:m, :n]


@matmul.defbackend("torch")
def _matmul_torch(a, b, *, out_dtype=None):
    return ref.matmul_ref(a, b, out_dtype)


flash_attention = plain_op(
    "flash_attention", tile_args=("bq", "bk"),
    doc="Blockwise-softmax attention; q/k/v in model layout (B, S, H, hd).",
)


@flash_attention.defbackend("torch")
def _flash_attention_torch(q, k, v, *, causal=True, q_offset=0):
    out = ref.flash_attention_ref(
        flatten_heads(q), flatten_heads(k), flatten_heads(v),
        causal=causal, q_offset=q_offset,
    )
    return unflatten_heads(out, q.shape[0])


ssm_scan = plain_op(
    "ssm_scan", tile_args=("chunk",),
    doc="Chunked SSD scan; u (B,S,H,P), a_log (B,S,H), b/c (B,S,N) head-shared.",
)


@ssm_scan.defbackend("torch")
def _ssm_scan_torch(u, a_log, b, c):
    y = ref.ssm_scan_ref(*flatten_ssm(u, a_log, b, c))
    return unflatten_heads(y, u.shape[0])


__all__ = [
    "BACKENDS",
    "KernelOp",
    "KernelPolicy",
    "axpy",
    "current_policy",
    "default_backend",
    "flash_attention",
    "get_op",
    "kernel_op",
    "kernel_policy",
    "matmul",
    "op_names",
    "pchase",
    "plain_op",
    "resolve_backend",
    "ssm_scan",
    "stream_copy",
    "stream_reduce",
    "strided_reduce",
]
