"""Model definitions (port of ``repro.models``): the dense transformer LM and
the Zamba2 hybrid (Mamba2 + shared attention)."""
from .api import ModelApi, build_model

__all__ = ["ModelApi", "build_model"]
