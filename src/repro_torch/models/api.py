"""Unified model API: one façade over the model families.

Port of ``repro.models.api``.  ``build_model(cfg)`` returns a
:class:`ModelApi`, a frozen bundle of functions closed over the config.
State (params, caches) flows through arguments and return values, never
through the object.  The port has every family of the reference: dense, MoE,
VLM, the recurrent ``ssm`` family (xlstm), hybrid (zamba2) and
encoder-decoder (whisper).

Two KV-cache layouts coexist behind the same façade, as in the reference:

- **dense** — ``init_cache(batch, max_len)`` reserves one contiguous
  ``max_len`` region per lane; ``decode_step``/``decode_chunk`` index it
  directly.
- **paged** — ``init_paged_cache(n_pages, page_size)`` builds one global
  page pool shared by all lanes; ``decode_step_paged``/``decode_chunk_paged``
  take an extra ``block_table (B, T)`` mapping each lane's logical position
  ``t`` to pool page ``bt[b, t // page]``.

The ssm, hybrid and encoder-decoder families keep ``decode_chunk`` and the
paged fields ``None``, as in the reference, so the serving engine refuses
them.
The reference's ``cache_shardings``/``paged_cache_shardings`` fields are
``dist.cache_shardings``/``paged_cache_shardings`` of the family's config,
which the serving engine calls.  Every family computes on a ``model`` axis
> 1 (``dist.activation_sharding``, params placed by ``dist.param_specs``);
its ``prefill`` returns this rank's part of the cache as the rule lays it,
and ``decode_step`` takes it so.  Under ZeRO-3 the ssm, hybrid and
encoder-decoder families' ``loss_fn`` gathers the stored params whole over
``data`` before the forward, keeping the ``model`` shards (:func:`_whole`);
the decoder families gather a layer at a time inside their blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist import zero

from . import attention as attn
from . import encdec, mamba, transformer, xlstm
from . import mlp as mlps
from .common import apply_rope, as_dtype, rmsnorm, token_positions


@dataclass(frozen=True)
class ModelApi:
    """Per-family model surface.

    Field contracts (shapes use B=batch/lanes):

    - ``init(gen) -> params`` on the generator's device, which must be the
      model's
    - ``loss_fn(params, batch) -> scalar``
    - ``prefill(params, batch, max_len=None) -> (last_logits (B,V), cache)``
    - ``decode_step(params, cache, tokens (B,), pos (B,)) -> (logits (B,V), cache)``
    - ``init_cache(batch, max_len)`` a zeroed dense per-lane KV cache on the
      model's device; ``cache_specs(batch, max_len)`` the same on the
      ``meta`` device (no storage)
    - ``decode_chunk(params, cache, tokens (B,C), positions (B,C)) -> (logits
      (B,C,V), cache)``: C decode-step-equivalent steps in one call;
      positions == cache_len marks pad entries (no write, row ignored).
      None for families whose per-lane state cannot yet advance
      independently inside a shared batch (recurrent caches).
    - the paged twins (None where unsupported): ``init_paged_cache(n_pages,
      page_size)`` / ``paged_cache_specs`` build the global pool {"k"/"v":
      (L, n_pages, page, K, hd)}; ``decode_step_paged(params, cache,
      block_table, tokens (B,), pos (B,))`` and ``decode_chunk_paged(params,
      cache, block_table, tokens (B,C), positions (B,C))`` take the
      ``block_table (B, T)`` ahead of tokens/positions, and a position >=
      T*page means "pad: write nothing".  Gathering a lane's pages
      reproduces its dense cache exactly.
    """

    cfg: ModelConfig
    device: torch.device
    init: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    cache_specs: Callable
    decode_chunk: Optional[Callable] = None
    init_paged_cache: Optional[Callable] = None
    paged_cache_specs: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None
    decode_chunk_paged: Optional[Callable] = None


def _cache_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else as_dtype(cfg.dtype)


def build_model(cfg: ModelConfig, device="cuda") -> ModelApi:
    """The model surface for ``cfg`` on ``device`` (the card unless the
    caller passes ``"cpu"``)."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "encdec"):
        raise ValueError(f"unknown family {cfg.family!r}")
    device = torch.device(device)
    if cfg.family == "ssm":  # xlstm
        return _xlstm_model(cfg, device)
    if cfg.family == "hybrid":  # zamba2
        return _hybrid_model(cfg, device)
    if cfg.family == "encdec":  # whisper
        return _encdec_model(cfg, device)

    def init(gen: torch.Generator):
        _check_generator(gen, device)
        return transformer.lm_init(gen, cfg)

    def loss_fn(params, batch):
        return transformer.lm_loss(params, batch, cfg)

    def prefill(params, batch, max_len: Optional[int] = None):
        tokens = batch["tokens"]
        frontend = batch.get("frontend")
        ml = max_len if max_len is not None else tokens.shape[1] + (
            frontend.shape[1] if frontend is not None else 0
        )
        return transformer.lm_prefill(params, tokens, cfg, ml, frontend=frontend)

    def decode_step(params, cache, tokens, pos):
        return transformer.lm_decode_step(params, cache, tokens, pos, cfg)

    def init_cache(batch, max_len):
        return attn.init_cache(cfg, batch, max_len, cfg.n_layers, _cache_dtype(cfg), device)

    def cache_specs(batch, max_len):
        return attn.cache_specs(cfg, batch, max_len, cfg.n_layers, _cache_dtype(cfg))

    def decode_chunk(params, cache, tokens, positions):
        return transformer.lm_decode_chunk(params, cache, tokens, positions, cfg)

    def init_paged_cache(n_pages, page_size):
        return attn.init_paged_cache(cfg, n_pages, page_size, cfg.n_layers, _cache_dtype(cfg),
                                     device)

    def paged_cache_specs(n_pages, page_size):
        return attn.paged_cache_specs(cfg, n_pages, page_size, cfg.n_layers, _cache_dtype(cfg))

    def decode_step_paged(params, cache, block_table, tokens, pos):
        return transformer.lm_decode_step_paged(params, cache, block_table, tokens, pos, cfg)

    def decode_chunk_paged(params, cache, block_table, tokens, positions):
        return transformer.lm_decode_chunk_paged(params, cache, block_table, tokens, positions,
                                                 cfg)

    return ModelApi(cfg, device, init, loss_fn, prefill, decode_step, init_cache, cache_specs,
                    decode_chunk=decode_chunk, init_paged_cache=init_paged_cache,
                    paged_cache_specs=paged_cache_specs, decode_step_paged=decode_step_paged,
                    decode_chunk_paged=decode_chunk_paged)


def _check_generator(gen: torch.Generator, device: torch.device) -> None:
    if torch.device(gen.device).type != device.type:
        raise ValueError(f"generator on {gen.device} for a model on {device}")


def _whole(fn: Callable) -> Callable:
    """``loss_fn(params, batch)`` taking ZeRO-3's stored params gathered
    whole over ``data`` (``dist.zero.whole_tree``: each keeps its ``model``
    shard) before the forward, for the families whose blocks do not gather
    a layer at a time."""

    def run(params, batch):
        return fn(zero.whole_tree(params), batch)

    return run


def _xlstm_model(cfg: ModelConfig, device: torch.device) -> ModelApi:
    def init(gen: torch.Generator):
        _check_generator(gen, device)
        return xlstm.xlstm_init(gen, cfg)

    @_whole
    def loss_fn(params, batch):
        return xlstm.xlstm_loss(params, batch, cfg)

    def prefill(params, batch, max_len: Optional[int] = None):
        # recurrent: the cache is the final state, whatever max_len
        return xlstm.xlstm_prefill(params, batch["tokens"], cfg)

    def decode_step(params, cache, tokens, pos):
        return xlstm.xlstm_decode_step(params, cache, tokens, pos, cfg)

    def init_cache(batch, max_len):
        return xlstm.xlstm_init_cache(cfg, batch, max_len, device=device)

    def cache_specs(batch, max_len):
        return xlstm.xlstm_cache_specs(cfg, batch, max_len)

    return ModelApi(cfg, device, init, loss_fn, prefill, decode_step, init_cache, cache_specs)


def _hybrid_model(cfg: ModelConfig, device: torch.device) -> ModelApi:
    def init(gen: torch.Generator):
        _check_generator(gen, device)
        return mamba.zamba_init(gen, cfg)

    @_whole
    def loss_fn(params, batch):
        return mamba.zamba_loss(params, batch, cfg)

    def prefill(params, batch, max_len: Optional[int] = None):
        ml = max_len if max_len is not None else batch["tokens"].shape[1]
        return _zamba_prefill(params, batch["tokens"], cfg, ml)

    def decode_step(params, cache, tokens, pos):
        return mamba.zamba_decode_step(params, cache, tokens, pos, cfg)

    def init_cache(batch, max_len):
        return mamba.zamba_init_cache(cfg, batch, max_len, _cache_dtype(cfg), device)

    def cache_specs(batch, max_len):
        return mamba.zamba_cache_specs(cfg, batch, max_len, _cache_dtype(cfg))

    return ModelApi(cfg, device, init, loss_fn, prefill, decode_step, init_cache, cache_specs)


def _encdec_model(cfg: ModelConfig, device: torch.device) -> ModelApi:
    """``batch["frontend"]`` holds the frame embeddings (B, F, d)."""
    def init(gen: torch.Generator):
        _check_generator(gen, device)
        return encdec.encdec_init(gen, cfg)

    @_whole
    def loss_fn(params, batch):
        return encdec.encdec_loss(params, batch, cfg)

    def prefill(params, batch, max_len: Optional[int] = None):
        ml = max_len if max_len is not None else batch["tokens"].shape[1]
        return encdec.encdec_prefill(params, batch["frontend"], batch["tokens"], cfg, ml)

    def decode_step(params, cache, tokens, pos):
        return encdec.encdec_decode_step(params, cache, tokens, pos, cfg)

    def init_cache(batch, max_len):
        return encdec.encdec_init_cache(cfg, batch, max_len, _cache_dtype(cfg), device)

    def cache_specs(batch, max_len):
        return encdec.encdec_cache_specs(cfg, batch, max_len, _cache_dtype(cfg))

    return ModelApi(cfg, device, init, loss_fn, prefill, decode_step, init_cache, cache_specs)


# ---------------------------------------------------------------------------
# recurrent-family prefill
# ---------------------------------------------------------------------------
def _zamba_prefill(params, tokens, cfg, max_len):
    """Full forward that also builds the decode state.

    Returns (last_logits (B,V), cache) with KV length ``max_len`` >= S: each
    shared-attention application's (k, v), and each Mamba2 layer's final SSM
    state (from the plain stateful scan, as in the reference) and last W-1
    conv inputs, written straight into a zeroed cache.  Under a
    tensor-parallel mesh the cache is laid out by the rule: this rank's KV
    heads where the ``model`` axis divides them, the SSM and conv state whole
    (each layer's local heads' final state and conv inputs gathered once).
    """
    x = transformer.embed_tokens(params, tokens, cfg)
    x0 = x
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_len}")
    positions = token_positions(b, s, x.device)
    lo, hi = tp.local_range(cfg.n_kv_heads)  # this rank's KV heads
    cache = mamba.zamba_init_cache(cfg.replace(n_kv_heads=hi - lo), b, max_len,
                                   _cache_dtype(cfg), x.device)
    sp = params["shared_attn"]
    width = cfg.ssm_conv_width - 1
    d_in, _, _ = mamba.mamba_dims(cfg)

    def attn_prefill(x, slot):
        xin = rmsnorm(sp["norm"], torch.cat([x, x0], dim=-1), cfg.norm_eps)
        q, k, v = attn.qkv_proj(sp["attn"], xin, cfg)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = attn.attention_impl(cfg)(q, attn.local_kv(k, cfg), attn.local_kv(v, cfg), causal=True)
        x = x + tp.reduce(attn.out_proj(sp["attn"], o, x.dtype), cfg.n_heads)
        cache["k"][slot, :, :s] = k
        cache["v"][slot, :, :s] = v
        return x + mlps.mlp(sp["mlp"], rmsnorm(sp["mlp_norm"], x, cfg.norm_eps), cfg)

    def mamba_prefill(x, lp, li):
        xin = rmsnorm(lp["norm"], x, cfg.norm_eps)
        y, h = mamba.mamba_forward(lp, xin, cfg, return_state=True)
        # conv state = the last W-1 conv inputs (only those rows are projected)
        tail_in = xin[:, -width:]
        cache["ssm"][li] = tp.gather(h, d_in, 1)
        cache["conv"][li] = torch.cat([tp.gather(tail_in @ lp["w_in"].to(x.dtype), d_in, -1),
                                       tail_in @ lp["w_bc"].to(x.dtype)], dim=-1)
        return x + y

    li = 0
    for slot, layers in enumerate(mamba._units(params, cfg)):
        x = attn_prefill(x, slot)
        for lp in layers:
            x = mamba_prefill(x, lp, li)
            li += 1
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)[:, 0]
    logits = mamba.zamba_logits(params, x, cfg)
    cache["x0"] = x0[:, -1]
    return logits, cache
