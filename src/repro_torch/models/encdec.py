"""Whisper-style encoder-decoder backbone.

Port of ``repro.models.encdec``.  The conv/mel frontend is a stub, as in
the reference: the caller supplies precomputed frame embeddings (B,
frontend_len, d_model).  Sinusoidal absolute positions on both encoder and
decoder (the reference's deviation from Whisper's learned decoder
positions).  Parameters are layer-stacked (``enc_layers`` and
``dec_layers`` lead with the layer axis); the layers run as a Python loop,
each checkpointed (``common.remat``) when ``cfg.remat`` is set and grad is
enabled.
With ``attn_impl="pallas"`` the encoder (non-causal), the decoder's self
attention (causal) and its cross attention (non-causal, Sq != Skv) go
through the flash kernel; the decode step is plain torch ops, as the
reference's is plain jnp.
"""
from __future__ import annotations

from functools import partial

import torch

from . import attention as attn
from . import mlp as mlps
from .common import (
    Params,
    as_dtype,
    embed_init,
    layernorm,
    layernorm_init,
    mask_vocab_pad,
    remat,
    sinusoidal_positions,
    softmax_xent,
    token_positions,
)
from .transformer import embed_tokens, layer_list, layer_params


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def encdec_init(gen: torch.Generator, cfg) -> Params:
    """Fresh params on ``gen``'s device, layer-stacked as the reference's."""
    dtype = as_dtype(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    enc, dec = (cfg.n_enc_layers,), (cfg.n_dec_layers,)

    def norm(stack=()):
        return layernorm_init(d, dtype, stack=stack, device=dev)

    return {
        "embed": embed_init(gen, (cfg.padded_vocab, d), dtype),
        "enc_layers": {
            "attn_norm": norm(enc),
            "attn": attn.attn_init(gen, cfg, dtype=dtype, stack=enc),
            "mlp_norm": norm(enc),
            "mlp": mlps.mlp_init(gen, cfg, dtype=dtype, stack=enc),
        },
        "enc_norm": norm(),
        "dec_layers": {
            "self_norm": norm(dec),
            "self_attn": attn.attn_init(gen, cfg, dtype=dtype, stack=dec),
            "cross_norm": norm(dec),
            "cross_attn": attn.attn_init(gen, cfg, dtype=dtype, stack=dec),
            "mlp_norm": norm(dec),
            "mlp": mlps.mlp_init(gen, cfg, dtype=dtype, stack=dec),
        },
        "dec_norm": norm(),
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _enc_block(cfg, p, x, positions):
    h = attn.attention_block(
        p["attn"], layernorm(p["attn_norm"], x, cfg.norm_eps), cfg, positions,
        causal=False, use_rope=False,
    )
    x = x + h
    return x + mlps.mlp(p["mlp"], layernorm(p["mlp_norm"], x, cfg.norm_eps), cfg)


def _cross_kv(p, enc_out):
    """The cross attention's K/V of the encoder states, biases included:
    position-independent, so the prefill computes them once per layer."""
    dt = enc_out.dtype
    k = torch.einsum("bfd,dkx->bfkx", enc_out, p["wk"].to(dt))
    v = torch.einsum("bfd,dkx->bfkx", enc_out, p["wv"].to(dt))
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k, v


def _cross(cfg, p, x, ck, cv):
    """Cross attention of the normed decoder states x (B, S, d) over the
    encoder's K/V: ``attention_block(kv_x=enc_out)`` with its K/V given."""
    dt = x.dtype
    q = torch.einsum("bsd,dhx->bshx", x, p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
    return attn.out_proj(p, attn.attention_impl(cfg)(q, ck, cv, causal=False), dt)


def _dec_block(cfg, p, x, positions, ck, cv):
    """One decoder layer over x (B, S, d) with the encoder's K/V; returns x
    and the self attention's (k, v) for the cache."""
    xin = layernorm(p["self_norm"], x, cfg.norm_eps)
    q, k, v = attn.qkv_proj(p["self_attn"], xin, cfg)
    x = x + attn.out_proj(p["self_attn"], attn.attention_impl(cfg)(q, k, v, causal=True),
                          x.dtype)
    x = x + _cross(cfg, p["cross_attn"], layernorm(p["cross_norm"], x, cfg.norm_eps), ck, cv)
    x = x + mlps.mlp(p["mlp"], layernorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
    return x, (k, v)


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------
def encode(params: Params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames: (B, F, d) precomputed frame embeddings (conv stub output)."""
    dt = as_dtype(cfg.dtype)
    b, f, _ = frames.shape
    x = frames.to(dt) + sinusoidal_positions(f, cfg.d_model, frames.device).to(dt)
    positions = token_positions(b, f, x.device)
    block = remat(partial(_enc_block, cfg), cfg)
    for lp in layer_list(params["enc_layers"]):
        x = block(lp, x, positions)
    return layernorm(params["enc_norm"], x, cfg.norm_eps)


def _logits(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The head tied to ``embed``, pad slots masked."""
    return mask_vocab_pad(torch.einsum("...d,vd->...v", x, params["embed"].to(x.dtype)), cfg)


def _decode(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor, cfg) -> tuple:
    """The teacher-forced decoder over tokens (B, S): its final hidden
    states (B, S, d) and each layer's self (k, v) and cross (k, v)."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(x.dtype)
    positions = token_positions(b, s, x.device)
    def layer(lp, x, enc_out):
        ck, cv = _cross_kv(lp["cross_attn"], enc_out)
        x, (k, v) = _dec_block(cfg, lp, x, positions, ck, cv)
        return x, (k, v, ck, cv)

    block = remat(layer, cfg)
    kvs = []
    for lp in layer_list(params["dec_layers"]):
        x, kv = block(lp, x, enc_out)
        kvs.append(kv)
    return layernorm(params["dec_norm"], x, cfg.norm_eps), kvs


def decode_train(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg) -> torch.Tensor:
    """tokens (B, S), enc_out (B, F, d) -> logits (B, S, V)."""
    return _logits(params, _decode(params, tokens, enc_out, cfg)[0], cfg)


def encdec_loss(params: Params, batch: dict, cfg) -> torch.Tensor:
    """Mean token cross-entropy."""
    enc_out = encode(params, batch["frontend"], cfg)
    logits = decode_train(params, batch["tokens"], enc_out, cfg)
    return softmax_xent(logits, batch["targets"]).mean()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def encdec_init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    """Self-attention KV (L, B, max_len, K, hd) and cross KV (L, B, F, K, hd)."""
    l, k, hd = cfg.n_dec_layers, cfg.n_kv_heads, cfg.head_dim
    shapes = {"self_k": max_len, "self_v": max_len,
              "cross_k": cfg.frontend_len, "cross_v": cfg.frontend_len}
    return {name: torch.zeros((l, batch, n, k, hd), dtype=dtype, device=device)
            for name, n in shapes.items()}


def encdec_cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """The cache's shapes and dtypes on the ``meta`` device (no storage)."""
    return encdec_init_cache(cfg, batch, max_len, dtype, device="meta")


def encdec_prefill(params: Params, frames: torch.Tensor, tokens: torch.Tensor, cfg,
                   max_len: int):
    """Encode + teacher-forced decoder pass building the self and cross KV
    caches.  Returns (last_logits (B, V), cache); the cross K/V hold the
    frames' own length."""
    enc_out = encode(params, frames, cfg)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_len}")
    x, kvs = _decode(params, tokens, enc_out, cfg)
    last = _logits(params, x[:, -1], cfg)
    cdt = torch.bfloat16 if cfg.dtype == "bfloat16" else x.dtype
    cache = encdec_init_cache(cfg, b, max_len, cdt, x.device)
    for name, i in (("cross_k", 2), ("cross_v", 3)):
        cache[name] = torch.stack([kv[i] for kv in kvs]).to(cdt)
    for i, (k, v, _, _) in enumerate(kvs):
        cache["self_k"][i, :, :s] = k
        cache["self_v"][i, :, :s] = v
    return last, cache


def encdec_decode_step(params: Params, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
                       cfg):
    """One decode step: tokens (B,), pos (B,) -> (logits (B, V), cache).

    The new token's self K/V is written into the cache passed in, which is
    returned (the reference's jitted step donates its buffer the same way);
    the cross attention reads the whole precomputed cross K/V, writing
    nothing.  The sinusoid table spans the cache length; a position past it
    reads its last row, as the reference's clamped gather does."""
    b = tokens.shape[0]
    smax = cache["self_k"].shape[2]
    pe = sinusoidal_positions(smax, cfg.d_model, tokens.device)
    x = embed_tokens(params, tokens, cfg)
    x = x + pe[pos.long().clamp(0, smax - 1)].to(x.dtype)
    plan = attn.dense_write_plan(smax, pos[:, None])
    fpos = torch.full((b,), cache["cross_k"].shape[2] - 1, dtype=torch.int32,
                      device=tokens.device)
    for i in range(cfg.n_dec_layers):
        lp = layer_params(params["dec_layers"], i)
        xin = layernorm(lp["self_norm"], x, cfg.norm_eps)
        h, _, _ = attn.decode_attention(lp["self_attn"], xin, cfg, cache["self_k"][i],
                                        cache["self_v"][i], pos, use_rope=False, write_plan=plan)
        x = x + h
        xin = layernorm(lp["cross_norm"], x, cfg.norm_eps)
        # cross attention: static K/V, every frontend position visible
        h, _, _ = attn.decode_attention(lp["cross_attn"], xin, cfg, cache["cross_k"][i],
                                        cache["cross_v"][i], fpos, use_rope=False,
                                        update_cache=False)
        x = x + h
        x = x + mlps.mlp(lp["mlp"], layernorm(lp["mlp_norm"], x, cfg.norm_eps), cfg)
    x = layernorm(params["dec_norm"], x, cfg.norm_eps)
    return _logits(params, x, cfg), cache
