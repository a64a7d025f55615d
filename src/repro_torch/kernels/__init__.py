"""Hand-written Hopper kernels behind a unified dispatch API.

Probe kernels (the paper's microbenchmark methodology):
  - ``pchase``   pointer-chase dependent-load latency probe (Mei & Chu, §3.1)
  - ``membw``    streaming bandwidth probes (§3.2/3.7): ``stream_copy``,
                 ``stream_reduce`` and the load-granularity ``strided_reduce``
  - ``axpy``     the Ch.1 "wide accesses win" example as an access-width sweep

Compute kernels:
  - ``matmul``   tiled fp32-accumulating GEMM (the §4.4 GEMM-throughput probe)
  - ``flash_attention``  online-softmax attention (the LM's ``attn_impl="pallas"``)
  - ``ssm_scan`` the chunked Mamba2 SSD scan (the hybrid LM's ``ssm_impl="pallas"``)

Each kernel is CUDA C++ for ``sm_90a`` under ``csrc/``, built on first use,
and is validated against the plain PyTorch versions in ``ref.py``.

``api.py`` is the public entry point: every op has a ``cuda`` backend (the
hand kernel) and a ``torch`` backend (the ref.py oracle).  ``guard.py`` is
the numerics guard: under ``kernel_policy(guard="sample"|"shadow")`` the
``cuda`` calls are shadowed by the oracle, saturation is bounded, and a
drifting op is quarantined to the oracle.
"""
