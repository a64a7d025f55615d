"""The microbenchmark engine: probes, timing, pointer-chase analysis and
``dissect``, which fits a ``HardwareModel`` (``repro_torch.hw``) from the
probes' measurements."""
