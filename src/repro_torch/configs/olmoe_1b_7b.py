"""OLMoE-1B-7B — 16L d_model=2048 16H (GQA kv=16) per-expert d_ff=1024,
vocab 50304, MoE 64 experts top-8.  [arXiv:2409.02060; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    mlp_variant="swiglu",
    rope_theta=10_000.0,
    # 64 experts / 16-way model axis -> 4 experts per device (EP); per-expert
    # d_ff=1024 is too narrow to TP-shard (1024/16=64 < 128 lanes), so EP only.
    moe_shard="expert",
)
