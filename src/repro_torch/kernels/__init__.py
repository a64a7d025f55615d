"""Hand-written Hopper kernels behind a unified dispatch API.

Probe kernels (the paper's microbenchmark methodology):
  - ``pchase``   pointer-chase dependent-load latency probe (Mei & Chu, §3.1)
  - ``membw``    streaming bandwidth probe (§3.2/3.7); ``stream_reduce`` has a
                 kernel, ``stream_copy`` and ``strided_reduce`` plain versions
  - ``axpy``     the Ch.1 "wide accesses win" example as an access-width sweep

Compute kernels:
  - ``matmul``   tiled fp32-accumulating GEMM (the §4.4 GEMM-throughput probe)

Each kernel is CUDA C++ for ``sm_90a`` under ``csrc/``, built on first use,
and is validated against the plain PyTorch versions in ``ref.py``.

``api.py`` is the public entry point: every op has a ``cuda`` backend (the
hand kernel; not yet for flash_attention, ssm_scan, stream_copy and
strided_reduce) and a ``torch`` backend (the ref.py oracle).
"""
