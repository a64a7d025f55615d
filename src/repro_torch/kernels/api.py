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
``"cuda"`` with CPU tensors raises.

A context-local :func:`kernel_policy` scopes the backend, tile overrides and
autotuning::

    with kernel_policy(backend="cuda", autotune=True):
        y = api.matmul(a, b)          # tiles from core.autotune, cached

Tile kwargs resolve as the reference's: explicit kwarg > ``policy.tiles[op]``
> autotune (when the policy enables it; ``choose_matmul_tiles``,
``choose_attention_chunk``, ``choose_ssm_chunk``, memoized in the
:class:`repro_torch.core.tuning.TuningCache` keyed on ``(op, shapes, dtype,
backend)``) > the implementation's defaults.  The autotuners cost tiles for
the H100 (``hw="nvidia-h100-sxm"``) when the tensors lie on the card, and for
the reference's default part (TPU v5e) when they lie on the CPU, so a CPU
parity test resolves the reference's tiles for the same arguments.  The
numerics guard waits for the port of ``kernels/guard.py``.
"""
from __future__ import annotations

import inspect
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.core import tuning
from repro_torch.core.autotune import (
    choose_attention_chunk,
    choose_matmul_tiles,
    choose_ssm_chunk,
    dtype_name,
)

from . import axpy as _axpy
from . import flash_attention as _fa
from . import matmul as _mm
from . import membw as _bw
from . import pchase as _pc
from . import ref
from . import ssm_scan as _ssd
from ._util import (fit_block, flatten_heads, flatten_heads_padded, flatten_ssm, pad_to_multiple,
                    unflatten_heads)

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

    ``backend`` of None defers to :func:`default_backend`; ``autotune``
    lets :mod:`repro_torch.core.autotune` pick the tile kwargs nothing else
    pins; ``tiles`` maps op name -> tile-kwarg overrides (e.g. ``{"matmul":
    {"bm": 256}}``) and is merged across nested policies.
    """

    backend: Optional[str] = None
    autotune: bool = False
    tiles: dict = field(default_factory=dict)


_POLICY: ContextVar[KernelPolicy] = ContextVar("kernel_policy", default=KernelPolicy())


def current_policy() -> KernelPolicy:
    return _POLICY.get()


@contextmanager
def kernel_policy(backend: Optional[str] = None, autotune: Optional[bool] = None,
                  tiles: Optional[dict] = None, guard: Optional[str] = None):
    """Scoped policy override; unspecified fields inherit from the enclosing
    policy, and the previous policy is restored on exit (exception-safe)."""
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
        backend=outer.backend if backend is None else backend,
        autotune=outer.autotune if autotune is None else autotune,
        tiles=merged_tiles,
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
    resolved as: explicit kwarg > policy.tiles[op] > autotune (when the
    policy enables it) > the implementation's defaults, and reach only the
    ``cuda`` backend.
    """

    def __init__(self, name: str, tile_args: tuple = (),
                 autotuner: Optional[Callable] = None, doc: str = ""):
        self.name = name
        self.tile_args = tuple(tile_args)
        self.autotuner = autotuner  # (args tuple) -> {tile kwarg: value}
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
            bound = sorted(self._impls)
            raise KeyError(
                f"op {self.name!r} has no backend {backend!r} (bound: {bound})"
            ) from None

    # -- dispatch -----------------------------------------------------------
    def resolve_tiles(self, args, kwargs=None, backend: str = "cuda") -> dict:
        """``kwargs`` with the tile kwargs the current policy adds for these
        ``args``: explicit kwarg > policy.tiles[op] > autotune (cached under
        ``(op, shapes, dtype, backend)``) > left to the implementation."""
        pol = current_policy()
        out = dict(kwargs or {})
        for k, v in pol.tiles.get(self.name, {}).items():
            if k in self.tile_args:
                out.setdefault(k, v)
        if pol.autotune and self.autotuner is not None:
            if any(t not in out for t in self.tile_args):
                cache = tuning.get_cache()
                key = tuning.make_key(self.name, args, backend)
                tuned = cache.lookup(key)
                if tuned is None:
                    tuned = self.autotuner(args)
                    cache.store(key, tuned)
                for t, v in tuned.items():
                    out.setdefault(t, v)
        return out

    def bound(self, *args, backend: Optional[str] = None, **kwargs) -> Callable:
        """Resolve dispatch (backend, tiles, kwarg filtering) for these
        ``args`` once and return the impl partially applied with the final
        kwargs — timing loops call the result directly, keeping Python
        dispatch out of the measured path."""
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
            kwargs = self.resolve_tiles(args, kwargs, be)
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


def kernel_op(name: str, *, tile_args: tuple = (), autotuner: Optional[Callable] = None):
    """Register the decorated function as op ``name``'s ``cuda`` implementation
    and return the :class:`KernelOp` dispatcher.  Bind further backends with
    ``@<op>.defbackend("torch")``."""

    def deco(cuda_fn: Callable) -> KernelOp:
        op = KernelOp(name, tile_args, autotuner, doc=(cuda_fn.__doc__ or ""))
        op.bind("cuda", cuda_fn)
        return _register(op)

    return deco


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
# autotuners (core.autotune glue): the H100's model for tensors on the card,
# the reference's default part (TPU v5e) for CPU tensors
# ---------------------------------------------------------------------------
def _autotune_hw(t: torch.Tensor) -> dict:
    return {"hw": "nvidia-h100-sxm"} if t.device.type == "cuda" else {}


def _matmul_autotuner(args) -> dict:
    a, b = args[0], args[1]
    (m, k), n = a.shape, b.shape[1]
    tc = choose_matmul_tiles(m, k, n, dtype_name(a.dtype), **_autotune_hw(a))
    return {"bm": tc.bm, "bk": tc.bk, "bn": tc.bn}


def _attention_autotuner(args) -> dict:
    q, k = args[0], args[1]
    _, sq, h, hd = q.shape
    chunk = choose_attention_chunk(k.shape[1], hd, h, dtype_name(q.dtype), **_autotune_hw(q))
    return {"bq": fit_block(128, sq), "bk": chunk}


def _ssm_autotuner(args) -> dict:
    u, b = args[0], args[2]
    return {
        "chunk": choose_ssm_chunk(u.shape[1], u.shape[-1], b.shape[-1], dtype_name(u.dtype),
                                  **_autotune_hw(u))
    }


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


@kernel_op("stream_copy", tile_args=("block_rows", "block_cols"))
def stream_copy(x, *, block_rows=8, block_cols=512):
    """HBM->SM->HBM round-trip bandwidth probe."""
    return _bw.stream_copy(x, block_rows=block_rows, block_cols=block_cols)


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


@kernel_op("strided_reduce", tile_args=("block_rows",))
def strided_reduce(x, *, stride, block_rows=64):
    """Sparse-access reduce probing load granularity (paper Tab 3.1).  The
    kernel sums what the reference's Pallas kernel sums (the stride restarts
    in every block of ``block_rows``); the ``torch`` backend is the
    reference's oracle ``x[::stride]``, equal when ``stride`` divides
    ``block_rows``."""
    return _bw.strided_reduce(x, stride=stride, block_rows=block_rows)


@strided_reduce.defbackend("torch")
def _strided_reduce_torch(x, *, stride):
    return ref.strided_reduce_ref(x, stride)


@kernel_op("pchase")
def pchase(perm, steps):
    """Dependent-load pointer chase; returns the final index as (1,1) int32."""
    return _pc.pchase_cuda(perm, steps)


pchase.defbackend("torch")(_pc.pchase_torch)


@kernel_op("matmul", tile_args=("bm", "bn", "bk"), autotuner=_matmul_autotuner)
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


@kernel_op("flash_attention", tile_args=("bq", "bk"), autotuner=_attention_autotuner)
def flash_attention(q, k, v, *, causal=True, q_offset=0, bq=128, bk=128):
    """Blockwise-softmax attention; q (B, Sq, H, hd), k/v (B, Skv, Hkv, hd)
    with H % Hkv == 0, query head ``h`` reading KV head ``h // (H // Hkv)``
    (the reference's ``jnp.repeat`` order).  bf16/fp16 go to the tensor-core
    kernel in the model layout: it reads the grouped KV heads in place and
    masks rows past S itself, so nothing is expanded or padded (but hd, where
    a row is not a multiple of 16 bytes) and ``bq`` and ``bk`` change nothing
    there.  fp32, as in the reference: the KV heads are expanded, Sq and Skv
    are zero-padded to the (clamped) block sizes, the kernel masks keys past
    the true Skv, and the padded query rows are sliced off; hd is zero-padded
    to the fp32 kernel's template width in the same copy, with the true
    ``hd ** -0.5`` as the scale."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    if q.dtype in _fa.TMA_DTYPES:
        return _fa.flash_attention_model(q, k, v, causal=causal, q_offset=q_offset)
    k, v = _fa.expand_kv_heads(k, v, h)
    bq_, bk_ = fit_block(bq, sq), fit_block(bk, skv)
    width = _fa.kernel_head_dim(hd)
    qf = flatten_heads_padded(q, -(-sq // bq_) * bq_, width)
    kf, vf = (flatten_heads_padded(t, -(-skv // bk_) * bk_, width) for t in (k, v))
    out = _fa.flash_attention_cuda(qf, kf, vf, causal=causal, q_offset=q_offset,
                                   bq=bq_, bk=bk_, kv_len=skv, scale=hd ** -0.5)
    return unflatten_heads(out[:, :sq, :hd], b)


@flash_attention.defbackend("torch")
def _flash_attention_torch(q, k, v, *, causal=True, q_offset=0):
    k, v = _fa.expand_kv_heads(k, v, q.shape[2])
    out = ref.flash_attention_ref(
        flatten_heads(q), flatten_heads(k), flatten_heads(v),
        causal=causal, q_offset=q_offset,
    )
    return unflatten_heads(out, q.shape[0])


@kernel_op("ssm_scan", tile_args=("chunk",), autotuner=_ssm_autotuner)
def ssm_scan(u, a_log, b, c, *, chunk=256):
    """Chunked SSD scan; u (B,S,H,P), a_log (B,S,H), b/c (B,S,N) head-shared.
    As in the reference, the chunk is clamped to S, S is zero-padded to a
    multiple of it (a_log 0 is a decay of 1 and u, b, c 0 add nothing) and
    the padded steps are sliced off."""
    s = u.shape[1]
    chunk = fit_block(chunk, s)
    # split and padded views of the model's tensors; the kernel takes contiguous rows
    u, a_log, b, c = (pad_to_multiple(x, chunk, 1).contiguous() for x in (u, a_log, b, c))
    return _ssd.ssm_scan_cuda(u, a_log, b, c, chunk=chunk)[:, :s]


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
    "resolve_backend",
    "ssm_scan",
    "stream_copy",
    "stream_reduce",
    "strided_reduce",
]
