"""Model definitions (port of ``repro.models``): the dense transformer LM."""
from .api import ModelApi, build_model

__all__ = ["ModelApi", "build_model"]
