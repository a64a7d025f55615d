"""Whisper-base — enc-dec, 6L encoder + 6L decoder, d_model=512 8H,
d_ff=2048, vocab 51865.  Conv/mel frontend is a STUB: ``input_specs``
provides precomputed frame embeddings (1500, d_model).  [arXiv:2212.04356]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    n_enc_layers=6,
    n_dec_layers=6,
    mlp_variant="gelu",
    frontend="audio",
    frontend_len=1500,  # 30 s of mel frames after the conv stub
    qkv_bias=True,
)
