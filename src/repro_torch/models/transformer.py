"""Decoder-only transformer LM, dense family (gemma/qwen/minitron/yi).

Port of ``repro.models.transformer``'s dense path.  Parameters are
layer-stacked as in the reference (``params["layers"][name]`` has a leading
``n_layers`` axis); the layers run as a Python loop over that axis.  The
reference's sharding pins are multi-device and are left out; MoE and the
VLM frontend are queued in ROADMAP.md.  The serving engine's steps —
chunked decode (``lm_decode_chunk``) and its paged twins — are plain torch
ops, as the reference's are plain jnp.
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


def _block_decode(cfg, p: Params, x: torch.Tensor, ck, cv, pos, plan):
    """Single-token decode block. x: (B,d); the token's KV goes into ck/cv
    in place through ``plan``."""
    xin = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    h, ck, cv = attn.decode_attention(p["attn"], xin, cfg, ck, cv, pos, write_plan=plan)
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

    The new token's KV is written into the cache passed in, which is
    returned (the reference's jitted step donates its buffer the same way).
    """
    x = embed_tokens(params, tokens, cfg)
    plan = attn.dense_write_plan(cache["k"].shape[2], pos[:, None])
    for i in range(cfg.n_layers):
        x, _, _ = _block_decode(cfg, layer_params(params["layers"], i), x,
                                cache["k"][i], cache["v"][i], pos, plan)
    x = rmsnorm(params["final_norm"], x[:, None, :], cfg.norm_eps)
    logits = lm_logits(params, x, cfg)[:, 0]
    return logits, cache


# ---------------------------------------------------------------------------
# chunked decode (the serving engine's batched prefill step)
# ---------------------------------------------------------------------------
def _chunk_attention(q, cache_k, cache_v, positions, cfg):
    """Chunk queries against the full KV cache with per-(lane, query) masks.

    q (B,C,H,hd); cache_k/v (B,Smax,K,hd); positions (B,C) — key index t is
    visible to query c of lane b iff t <= positions[b, c].  Pad queries
    (positions == Smax) see everything and produce garbage the caller drops.
    """
    b, c, h, hd = q.shape
    kh = cache_k.shape[2]
    g = h // kh
    qg = q.reshape(b, c, kh, g, hd).float()
    s = torch.einsum("bckgd,btkd->bckgt", qg, cache_k.float()) * hd ** -0.5
    smax = cache_k.shape[1]
    mask = (torch.arange(smax, device=q.device)[None, None, :]
            <= positions[:, :, None])  # (B,C,Smax)
    s = torch.where(mask[:, :, None, None, :], s, attn.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bckgt,btkd->bckgd", p, cache_v.float())
    o = o / torch.clamp_min(p.sum(dim=-1)[..., None], 1e-30)
    return o.reshape(b, c, h, hd).to(q.dtype)


def _block_decode_chunk(cfg, p: Params, x: torch.Tensor, ck, cv, positions, plan):
    """Chunked decode block: C new tokens per lane against one cache lane.

    x (B,C,d); ck/cv (B,Smax,K,hd); positions (B,C).  Writes the chunk's KV
    into the cache first (in place, through ``plan``), then attends — intra-chunk causality
    falls out of the t <= positions mask because every chunk key already
    sits in the cache at its own position.
    """
    xin = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    q, k, v = attn.qkv_proj(p["attn"], xin, cfg)
    q = attn.apply_rope(q, positions, cfg.rope_theta)
    k = attn.apply_rope(k, positions, cfg.rope_theta)
    attn.put_kv_(ck, plan, k)
    attn.put_kv_(cv, plan, v)
    o = _chunk_attention(q, ck, cv, positions, cfg)
    x = x + attn.out_proj(p["attn"], o, x.dtype)
    y = mlps.mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
    return x + y, ck, cv


def lm_decode_chunk(params: Params, cache: dict, tokens: torch.Tensor,
                    positions: torch.Tensor, cfg):
    """Chunked batched prefill step: C tokens per lane in one call.

    tokens (B,C) int; positions (B,C) int gives each token's cache index in
    its own lane (lanes advance independently).  A position equal to Smax is
    padding: nothing is written and that query's logits row is garbage the
    caller ignores.  Returns (logits (B,C,V), cache) — exact continuation of
    ``lm_decode_step`` semantics, C steps at a time.  The chunk's KV is
    written into the cache passed in, which is returned.
    """
    x = embed_tokens(params, tokens, cfg)
    plan = attn.dense_write_plan(cache["k"].shape[2], positions)
    for i in range(cfg.n_layers):
        x, _, _ = _block_decode_chunk(cfg, layer_params(params["layers"], i), x,
                                      cache["k"][i], cache["v"][i], positions, plan)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# paged decode: same maths, cache indirected through a block table
# ---------------------------------------------------------------------------
def _block_decode_paged(cfg, p: Params, x: torch.Tensor, pk, pv, block_table, pos, plan):
    """Single-token decode block against the paged pool.  x: (B,d);
    pk/pv (N_pages, page, K, hd); block_table (B, T); written through
    ``plan`` in place."""
    xin = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    h, pk, pv = attn.paged_decode_attention(p["attn"], xin, cfg, pk, pv, block_table, pos,
                                            write_plan=plan)
    x = x + h
    y = mlps.mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
    return x + y, pk, pv


def _block_decode_chunk_paged(cfg, p: Params, x: torch.Tensor, pk, pv, block_table, positions,
                              plan):
    """Chunked decode block against the paged pool: C new tokens per lane.

    Pool-write first (through the block table, in place by ``plan``), then gather the lane's pages
    back to the dense layout and run the same chunk attention as the dense
    path — intra-chunk causality falls out of the t <= positions mask exactly
    as in :func:`_block_decode_chunk`.
    """
    xin = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    q, k, v = attn.qkv_proj(p["attn"], xin, cfg)
    q = attn.apply_rope(q, positions, cfg.rope_theta)
    k = attn.apply_rope(k, positions, cfg.rope_theta)
    attn.put_kv_(pk, plan, k)
    attn.put_kv_(pv, plan, v)
    ck = attn.gather_pages(pk, block_table)  # (B, T*page, K, hd)
    cv = attn.gather_pages(pv, block_table)
    o = _chunk_attention(q, ck, cv, positions, cfg)
    x = x + attn.out_proj(p["attn"], o, x.dtype)
    y = mlps.mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
    return x + y, pk, pv


def lm_decode_chunk_paged(params: Params, cache: dict, block_table: torch.Tensor,
                          tokens: torch.Tensor, positions: torch.Tensor, cfg):
    """Paged twin of :func:`lm_decode_chunk`.

    cache holds the global page pool {"k"/"v": (L, N_pages, page, K, hd)};
    ``block_table`` (B, T) int maps each lane's logical positions to pages
    (position t -> page ``bt[b, t // page]``, offset ``t % page``).  A
    position >= T*page is padding: nothing is written and that row's logits
    are garbage the caller ignores.  Exact vs the dense path: gathering a
    lane's pages reproduces its dense cache bit-for-bit.  The pool passed in
    is written in place and returned.
    """
    x = embed_tokens(params, tokens, cfg)
    plan = attn.paged_write_plan(cache["k"].shape[2], block_table, positions)
    for i in range(cfg.n_layers):
        x, _, _ = _block_decode_chunk_paged(cfg, layer_params(params["layers"], i), x,
                                            cache["k"][i], cache["v"][i], block_table,
                                            positions, plan)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, x, cfg), cache


def lm_decode_step_paged(params: Params, cache: dict, block_table: torch.Tensor,
                         tokens: torch.Tensor, pos: torch.Tensor, cfg):
    """Paged twin of :func:`lm_decode_step`: one token per lane, KV gathered
    through the block table, in place.  Lanes with ``pos >= T*page`` (empty
    slots) write nothing and produce garbage logits the engine ignores."""
    x = embed_tokens(params, tokens, cfg)
    plan = attn.paged_write_plan(cache["k"].shape[2], block_table, pos[:, None])
    for i in range(cfg.n_layers):
        x, _, _ = _block_decode_paged(cfg, layer_params(params["layers"], i), x,
                                      cache["k"][i], cache["v"][i], block_table, pos, plan)
    x = rmsnorm(params["final_norm"], x[:, None, :], cfg.norm_eps)
    logits = lm_logits(params, x, cfg)[:, 0]
    return logits, cache
