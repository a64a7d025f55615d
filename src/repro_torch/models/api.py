"""Unified model API: one façade over the model families.

Port of ``repro.models.api``.  ``build_model(cfg)`` returns a
:class:`ModelApi`, a frozen bundle of functions closed over the config.
State (params, caches) flows through arguments and return values, never
through the object.  The port has the dense family so far; the others raise
``NotImplementedError`` naming the family, and ``decode_chunk`` and the
paged-cache twins stay ``None`` until the serving engine is ported
(ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig

from . import attention as attn
from . import transformer
from .common import as_dtype


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
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (queued in ROADMAP.md); "
            "build_model supports the dense family"
        )
    device = torch.device(device)

    def init(gen: torch.Generator):
        if torch.device(gen.device).type != device.type:
            raise ValueError(f"generator on {gen.device} for a model on {device}")
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

    return ModelApi(cfg, device, init, loss_fn, prefill, decode_step, init_cache, cache_specs)
