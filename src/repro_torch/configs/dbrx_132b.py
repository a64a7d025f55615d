"""DBRX-132B — 40L d_model=6144 48H (GQA kv=8) per-expert d_ff=10752,
vocab 100352, MoE 16 experts top-4 (fine-grained).  [hf:databricks/dbrx-base]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    experts_per_token=4,
    mlp_variant="swiglu",
    rope_theta=500_000.0,
    moe_shard="expert",  # 16 experts / 16-way model axis -> 1 expert per device
    # 132B bf16 = 264 GB exceeds a 16-chip TP replica's HBM; serving shards
    # weights over the data axis too (per-layer all-gather, FSDP-style)
    serve_param_fsdp=True,
)
