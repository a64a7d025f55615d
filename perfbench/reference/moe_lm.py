"""Plain float32 reference of a decoder with sparse experts (OLMoE's
shape): pre-norm blocks of rotary GQA attention and a top-k routed SwiGLU
expert layer, as the configuration's ``model`` block sizes it.

Routing groups and their capacity are inputs: each token names its group,
and each group its number of slots per expert.  Within a group an
assignment is kept while its expert has a free slot, in token-major order
(a token's k choices, then the next token's); a dropped assignment adds
nothing and its weight is not given to the others.  The routing weights are
the top k probabilities renormalised over the k.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Numerics, causal_attention, rmsnorm, rope


def _kept(top_e: torch.Tensor, groups: torch.Tensor, caps: torch.Tensor, n_experts: int):
    """Whether each assignment (T, k) finds a slot: its rank among the
    earlier assignments of its group to its expert is below the group's
    capacity."""
    t, k = top_e.shape
    key = (groups.repeat_interleave(k) * n_experts + top_e.reshape(-1)).long()
    order = torch.argsort(key, stable=True)
    ordered = key[order]
    first = torch.searchsorted(ordered, ordered)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=key.device) - first
    return (rank < caps[groups].repeat_interleave(k)).reshape(t, k)


def moe_layer(num: Numerics, p: dict, x: torch.Tensor, m: dict, groups, caps) -> tuple:
    """x (T, d) -> (y (T, d), the load-balancing loss of this layer)."""
    e, k = m["n_experts"], m["experts_per_token"]
    probs = torch.softmax(num.einsum("td,de->te", x, p["router"]), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    keep = _kept(top_e, groups, caps, e)
    y = torch.zeros_like(x)
    weight = top_p * keep
    for ex in range(e):
        hit = (top_e == ex) & keep
        tok = hit.any(dim=-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        w = (weight * hit)[tok].sum(dim=-1)
        xe = x[tok]
        h = F.silu(num.einsum("td,df->tf", xe, p["wi_gate"][ex])) * num.einsum(
            "td,df->tf", xe, p["wi_up"][ex])
        y = y.index_add(0, tok, num.einsum("tf,fd->td", h, p["wo"][ex]) * w[:, None])
    me = probs.mean(dim=0)
    ce = F.one_hot(top_e, e).float().sum(dim=(0, 1)) / top_e.numel()
    return y, e * torch.sum(me * ce)


def layer(num: Numerics, p: dict, x: torch.Tensor, m: dict, positions, groups, caps):
    """One block on x (B, S, d); returns (x, aux)."""
    b, s, d = x.shape
    h = rmsnorm(x, p["attn_norm"]["scale"], m["norm_eps"])
    a = p["attn"]
    q = rope(num.einsum("bsd,dhx->bshx", h, a["wq"]), positions, m["rope_theta"])
    kk = rope(num.einsum("bsd,dkx->bskx", h, a["wk"]), positions, m["rope_theta"])
    v = num.einsum("bsd,dkx->bskx", h, a["wv"])
    x = x + num.einsum("bshx,hxd->bsd", causal_attention(num, q, kk, v), a["wo"])
    h = rmsnorm(x, p["mlp_norm"]["scale"], m["norm_eps"])
    y, aux = moe_layer(num, p["moe"], h.reshape(b * s, d), m, groups, caps)
    return x + y.reshape(b, s, d), aux


def layer_params(layers: dict, i: int) -> dict:
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def forward(num: Numerics, params: dict, tokens: torch.Tensor, m: dict, groups, caps,
            remat: bool = False) -> tuple:
    """tokens (B, S) -> (logits (B, S, V) float32, the mean of the layers'
    load-balancing losses).  ``groups`` (B*S,) names each token's routing
    group, ``caps`` (G,) each group's slots per expert.  ``remat``
    recomputes each block in the backward (to fit a training step)."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].float()
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    aux = torch.zeros((), device=tokens.device)
    for i in range(m["n_layers"]):
        lp = layer_params(params["layers"], i)
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(layer, num, lp, x, m, positions, groups, caps, use_reentrant=False)
        else:
            x, a = layer(num, lp, x, m, positions, groups, caps)
        aux = aux + a
    x = rmsnorm(x, params["final_norm"]["scale"], m["norm_eps"])
    return num.einsum("bsd,dv->bsv", x, params["lm_head"]), aux / m["n_layers"]


def loss(num: Numerics, params: dict, batch: dict, m: dict, cap: int) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``moe_aux_coef`` times the mean
    load-balancing loss; every row is one routing group of ``cap`` slots."""
    tokens, targets = batch["tokens"], batch["targets"]
    b, s = tokens.shape
    groups = torch.arange(b, device=tokens.device).repeat_interleave(s)
    caps = torch.full((b,), cap, device=tokens.device)
    logits, aux = forward(num, params, tokens, m, groups, caps, remat=True)
    xent = torch.logsumexp(logits, dim=-1) - logits.gather(-1, targets.long()[..., None])[..., 0]
    return xent.mean() + m["moe_aux_coef"] * aux
