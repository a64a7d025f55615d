"""Shared block/layout helpers and the kernel library loader.

The layout helpers mirror ``repro.kernels._util`` so every backend of an op
accepts the same natural-layout arguments.

The hand-written kernels live in ``csrc/*.cu``, each with a plain C entry
point.  :func:`library` compiles them with ``nvcc`` for ``sm_90a`` on first
use (one ``nvcc`` per source, all started together, then one link into a
single shared library under ``build/repro_torch/``) and loads the result with
``ctypes``; importing this module compiles nothing, so the package imports on
a host with no CUDA toolkit.  :func:`launch` calls one entry point, raises on
a non-zero CUDA error code and counts the launch, and, for a kernel with
more than one route, the route it took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
#: element-type codes shared with csrc/common.cuh::ReproDtype
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3,
               torch.int32: 4, torch.float8_e4m3fn: 5}
#: the float types of every kernel that computes in floats
FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_LIB = None
_LAUNCHES: dict = {}
_ROUTES: dict = {}


def fit_block(block: int, dim: int) -> int:
    """Clamp a requested block size to the actual dimension."""
    return min(block, dim)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to the next multiple of ``multiple``."""
    pad = (-x.shape[axis]) % multiple
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def flatten_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) model layout -> (B*H, S, hd) kernel layout."""
    b, s, h, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, hd)


def flatten_heads_padded(x: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """(B, S, H, hd) model layout -> a contiguous (B*H, rows, width) kernel
    operand, zero past S and hd, written in one pass over ``x``."""
    b, s, h, hd = x.shape
    out = x.new_empty((b, h, rows, width))
    out[:, :, :s, :hd].copy_(x.permute(0, 2, 1, 3))
    out[:, :, s:].zero_()
    out[:, :, :s, hd:].zero_()
    return out.view(b * h, rows, width)


def unflatten_heads(x: torch.Tensor, batch: int) -> torch.Tensor:
    """(B*H, S, hd) kernel layout -> (B, S, H, hd) model layout."""
    bh, s, hd = x.shape
    return x.reshape(batch, bh // batch, s, hd).permute(0, 2, 1, 3)


def flatten_ssm(u, a_log, b, c):
    """SSD model layout -> per-(batch*head) layout, the plain versions'.

    u (B,S,H,P) -> (B*H,S,P); a_log (B,S,H) -> (B*H,S); head-shared b/c
    (B,S,N) are broadcast per head -> (B*H,S,N).  The CUDA kernel reads the
    model layout itself and never expands b/c.
    """
    bsz, s, h, p = u.shape
    n = b.shape[-1]
    uf = u.permute(0, 2, 1, 3).reshape(bsz * h, s, p)
    af = a_log.permute(0, 2, 1).reshape(bsz * h, s)
    bf = b[:, None].expand(bsz, h, s, n).reshape(bsz * h, s, n)
    cf = c[:, None].expand(bsz, h, s, n).reshape(bsz * h, s, n)
    return uf, af, bf, cf


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------
def launch_counts() -> dict:
    """Kernel launches per kernel name since the last reset."""
    return dict(_LAUNCHES)


def route_counts() -> dict:
    """Launches per route, {kernel: {route: count}}, since the last reset, for
    the kernels whose wrapper names a route."""
    return {k: dict(v) for k, v in _ROUTES.items()}


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
    _ROUTES.clear()


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into one shared library; return its path.

    The file name carries a hash of the sources and flags, so an edit to any
    source builds a new library and an unchanged tree reuses the last one.
    """
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        digest.update(path.name.encode() + path.read_bytes())
    lib_path = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        failures = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            if proc.returncode:
                failures.append(f"{src.name}:\n{out}")
        if failures:
            raise RuntimeError("nvcc failed on " + "\n".join(failures))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent build never sees half a file
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _entry(symbol: str, argtypes: tuple):
    fn = getattr(library(), symbol)
    if fn.argtypes is None:
        fn.argtypes = (*argtypes, ctypes.c_void_p)  # every entry point takes the stream last
        fn.restype = ctypes.c_int
    return fn


def launch(kernel: str, symbol: str, argtypes: tuple, device: torch.device, *args,
           route: str | None = None) -> None:
    """Call C entry point ``symbol`` on PyTorch's current stream of ``device``;
    raise on a CUDA error code, else count one launch of ``kernel`` (and one
    of its ``route``, when given)."""
    fn = _entry(symbol, argtypes)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} ({msg})")
    _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + 1
    if route is not None:
        routes = _ROUTES.setdefault(kernel, {})
        routes[route] = routes.get(route, 0) + 1


def check_cuda_operand(name: str, t: torch.Tensor, align: int = 16) -> None:
    """Raise unless ``t`` is contiguous and ``align``-byte aligned."""
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned (got a view at an offset)")
