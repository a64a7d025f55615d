"""Minitron-8B — 32L d_model=4096 32H (GQA kv=8) d_ff=16384, vocab 256000.
Pruned Nemotron-4.  [arXiv:2407.14679; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    mlp_variant="gelu",  # Nemotron-4 uses a non-gated squared-relu MLP; gelu here
    train_microbatches=2,
)
