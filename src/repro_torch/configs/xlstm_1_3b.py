"""xLSTM-1.3B — 48L d_model=2048 4H, vocab 50304, sLSTM + mLSTM blocks.
[arXiv:2405.04517]

d_ff=0 per the assignment: xLSTM blocks carry their own (gated) up/down
projections instead of a separate FFN.  Layer pattern: 6 macro-blocks of
(7 mLSTM + 1 sLSTM) = 48 layers (the paper's ~7:1 ratio).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    macro_size=8,  # scan unit: 7 mLSTM + 1 sLSTM
    xlstm_mlstm_per_macro=7,
    xlstm_slstm_per_macro=1,
    ssm_chunk=256,
    tie_embeddings=False,
)
