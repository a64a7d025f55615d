"""repro_torch — the PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s module tree; each module here has one
counterpart there, which stays the reference it is tested against.  This
first slice carries the paper's measure→model loop:

- ``repro_torch.kernels``  hand-written Hopper kernels (``kernels/csrc``) for
                           pchase, stream_reduce, axpy and matmul, behind the
                           op registry of ``kernels.api``
- ``repro_torch.core``     the probes, timing harness and ``dissect``
- ``repro_torch.hw``       the hardware spec database and ``fit_from_probes``
- ``repro_torch.bench``    ``python -m repro_torch.bench run dissect``

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "1.0.0"
