"""Zamba2-7B — 81L d_model=3584 32H d_ff=14336 vocab 32000, ssm_state=64.
Mamba2 backbone + one SHARED attention+MLP block applied periodically.
[arXiv:2411.15242]

Layout here: 27 macro-blocks x 3 Mamba2 layers (= 81 SSM layers, scanned),
with the shared attention block invoked every 2nd macro-block (14 calls).
The shared block takes concat(hidden, residual_embedding) = 2*d_model input,
per the Zamba design.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    macro_size=3,
    attn_every_k_macro=2,
    mlp_variant="gelu",
)
