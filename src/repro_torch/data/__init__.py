"""Data pipeline: deterministic synthetic token streams, background prefetch,
exact skip-ahead for fault-tolerant resume.  Port of ``repro.data``."""
from .pipeline import DataPipeline
from .synth import SyntheticLM, zipf_tokens

__all__ = ["SyntheticLM", "zipf_tokens", "DataPipeline"]
