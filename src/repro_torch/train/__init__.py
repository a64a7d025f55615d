"""Training substrate: step functions, microbatching, loop, fault tolerance.
Port of ``repro.train``."""
from .step import TrainState, make_train_step

__all__ = ["make_train_step", "TrainState"]
