"""InternVL2-76B — 80L d_model=8192 64H (GQA kv=8) d_ff=28672, vocab 128256.
InternViT frontend is a STUB: ``input_specs`` provides 256 precomputed patch
embeddings per image, prepended to the text sequence.  [arXiv:2404.16821]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    mlp_variant="swiglu",
    rope_theta=500_000.0,
    frontend="vision",
    frontend_len=256,
    train_microbatches=2,
    # §Perf hillclimb: 32k-prefill memory term minimized at KV-chunk 256
    # (score-tile traffic grows with chunk faster than q-pass savings)
    attn_chunk=256,
)
