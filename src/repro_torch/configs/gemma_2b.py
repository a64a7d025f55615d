"""Gemma-2B — 18L d_model=2048 8H (MQA kv=1) d_ff=16384, vocab 256000,
GeGLU, head_dim=256.  [arXiv:2403.08295; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    mlp_variant="geglu",
    tie_embeddings=True,
    train_microbatches=2,
)
