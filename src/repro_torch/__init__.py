"""repro_torch — the PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s module tree; each module here has one
counterpart there, which stays the reference it is tested against.  It
carries the paper's measure→model loop and the dense transformer LM:

- ``repro_torch.kernels``  hand-written Hopper kernels (``kernels/csrc``) for
                           pchase, stream_copy, stream_reduce, strided_reduce,
                           axpy, matmul and flash_attention, behind the op
                           registry of ``kernels.api``
- ``repro_torch.core``     the probes, timing harness and ``dissect``
- ``repro_torch.hw``       the hardware spec database and ``fit_from_probes``
- ``repro_torch.bench``    ``python -m repro_torch.bench run dissect``
- ``repro_torch.configs``  the architecture configs
- ``repro_torch.models``   ``build_model(cfg)``: the dense LM's prefill and
                           decode, attention through the flash kernel
- ``repro_torch.serve``    the serving engine: chunked prefill, dense and
                           paged KV, the numerics guard's shadow checks

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "1.0.0"
