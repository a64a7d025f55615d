"""Decoder-only transformer LM, dense family (gemma/qwen/minitron/yi).

Port of ``repro.models.transformer``'s dense path.  Parameters are
layer-stacked as in the reference (``params["layers"][name]`` has a leading
``n_layers`` axis); the layers run as a Python loop over that axis.  The
reference's sharding pins are multi-device and are left out; MoE and the
VLM frontend are queued in ROADMAP.md, as are ``lm_decode_chunk`` and the
paged twins, which come with the serving engine.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import attention as attn
from . import mlp as mlps
from .common import (
    Params,
    as_dtype,
    embed_init,
    mask_vocab_pad,
    rmsnorm,
    rmsnorm_init,
    scalar,
    softmax_xent,
    token_positions,
    tree_map,
)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def lm_init(gen: torch.Generator, cfg) -> Params:
    """Fresh params on ``gen``'s device, layer-stacked as the reference's."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (queued in ROADMAP.md); "
            "the port's transformer runs the dense family"
        )
    dtype = as_dtype(cfg.param_dtype)
    stack = (cfg.n_layers,)
    d, dev = cfg.d_model, gen.device
    p: Params = {
        "embed": embed_init(gen, (cfg.padded_vocab, d), dtype),
        "layers": {
            "attn_norm": rmsnorm_init(d, dtype, stack=stack, device=dev),
            "attn": attn.attn_init(gen, cfg, dtype=dtype, stack=stack),
            "mlp_norm": rmsnorm_init(d, dtype, stack=stack, device=dev),
            "mlp": mlps.mlp_init(gen, cfg, dtype=dtype, stack=stack),
        },
        "final_norm": rmsnorm_init(d, dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (d, cfg.padded_vocab), dtype)
    return p


def layer_params(layers: Params, i) -> Params:
    """Layer ``i``'s params (an index, or a tuple of them into several stacked
    axes): a view into each stacked tensor."""
    return tree_map(lambda a: a[i], layers)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _block_apply(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor):
    """Pre-norm block. x: (B,S,d). Returns (x, aux)."""
    h = attn.attention_block(
        p["attn"], rmsnorm(p["attn_norm"], x, cfg.norm_eps), cfg, positions, causal=True
    )
    x = x + h
    y = mlps.mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


def _block_prefill(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor):
    """Like _block_apply but also returns this layer's (k, v) for the cache."""
    xin = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    q, k, v = attn.qkv_proj(p["attn"], xin, cfg)
    q = attn.apply_rope(q, positions, cfg.rope_theta)
    k = attn.apply_rope(k, positions, cfg.rope_theta)
    o = attn.attention_impl(cfg)(q, k, v, causal=True)
    x = x + attn.out_proj(p["attn"], o, x.dtype)
    y = mlps.mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
    return x + y, (k, v)


def _block_decode(cfg, p: Params, x: torch.Tensor, ck, cv, pos):
    """Single-token decode block. x: (B,d)."""
    xin = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    h, ck, cv = attn.decode_attention(p["attn"], xin, cfg, ck, cv, pos)
    x = x + h
    y = mlps.mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
    return x + y, ck, cv


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------
def embed_tokens(params: Params, tokens: torch.Tensor, cfg,
                 frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather the rows, then cast: bit for bit the reference's cast-then-gather,
    without casting the whole table on every call."""
    dt = as_dtype(cfg.dtype)
    x = params["embed"][tokens].to(dt)
    if frontend is not None:  # VLM: prepend patch embeddings
        x = torch.cat([frontend.to(dt), x], dim=1)
    if cfg.name.startswith("gemma"):
        x = x * scalar(cfg.d_model**0.5, dt, x.device)
    return x


def lm_logits(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = x.dtype
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(dt))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(dt))
    return mask_vocab_pad(logits, cfg)


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------
def lm_forward(params: Params, tokens: torch.Tensor, cfg, frontend=None):
    """tokens (B,S_text) -> logits (B,S,V), aux.  S = S_text (+frontend)."""
    x = embed_tokens(params, tokens, cfg, frontend)
    b, s, _ = x.shape
    positions = token_positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = _block_apply(cfg, layer_params(params["layers"], i), x, positions)
        aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, x, cfg), aux


def lm_loss(params: Params, batch: dict, cfg) -> torch.Tensor:
    """Mean token cross-entropy (forward only; training is a later slice)."""
    frontend = batch.get("frontend")
    logits, _ = lm_forward(params, batch["tokens"], cfg, frontend)
    if frontend is not None:  # loss only over the text span
        logits = logits[:, frontend.shape[1]:]
    return softmax_xent(logits, batch["targets"]).mean()


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------
def lm_prefill(params: Params, tokens: torch.Tensor, cfg, max_len: int, frontend=None):
    """Full forward that also builds the KV cache.

    Returns (last_logits (B,V), cache) with cache len ``max_len`` >= S.
    Each layer's (k, v) is written straight into the zeroed cache.
    """
    x = embed_tokens(params, tokens, cfg, frontend)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_len}")
    positions = token_positions(b, s, x.device)
    cdt = torch.bfloat16 if cfg.dtype == "bfloat16" else x.dtype
    cache = attn.init_cache(cfg, b, max_len, cfg.n_layers, dtype=cdt, device=x.device)
    for i in range(cfg.n_layers):
        x, (k, v) = _block_prefill(cfg, layer_params(params["layers"], i), x, positions)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return lm_logits(params, x, cfg)[:, 0], cache


def lm_decode_step(params: Params, cache: dict, tokens: torch.Tensor, pos: torch.Tensor, cfg):
    """One decode step.  tokens (B,) int, pos (B,) int -> (logits (B,V), cache).

    The cache passed in is left as it was; the returned one is new.
    """
    x = embed_tokens(params, tokens, cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, ck, cv = _block_decode(cfg, layer_params(params["layers"], i), x,
                                  cache["k"][i], cache["v"][i], pos)
        ks.append(ck)
        vs.append(cv)
    x = rmsnorm(params["final_norm"], x[:, None, :], cfg.norm_eps)
    logits = lm_logits(params, x, cfg)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
