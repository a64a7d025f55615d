"""MLP variants (swiglu / geglu / gelu) and the MoE block.

Port of ``repro.models.mlp``.  MoE uses the reference's sort-free scatter
dispatch: top-k routing, position-within-expert via a one-hot cumsum,
capacity-bounded scatter into an (E, C, d) buffer per routing group, batched
expert matmuls, weighted gather-combine.  Under a tensor-parallel mesh the
MLP's columns, or the MoE's experts (``cfg.moe_shard == "expert"``) or each
expert's columns (``"ffn"``), are this rank's: every rank routes the whole
(replicated) token set, computes its part, and the caller or
:func:`moe_block` sums the parts over the ranks.  The router runs whole on
every rank; only the combine branch (the dispatched tokens and their
weights) enters the split computation through ``tp.copy``, since the aux
loss's gradient is whole already; on the transformer's sequence-parallel
stream S is gathered before the router (``tp.gather_seq``) and the output
reduce-scattered back to the slice.  The aux loss's router statistics are
means over the global batch (``dist.data_parallel.batch_mean``), as under
the reference's jitted step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import timing
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.data_parallel import batch_mean

from .common import Params, dense_init


def mlp_init(gen, cfg, d_in: int | None = None, dtype=torch.float32, *,
             stack: tuple = ()) -> Params:
    """MLP weights on ``gen``'s device; ``stack`` prepends a leading shape."""
    d = d_in if d_in is not None else cfg.d_model
    f = cfg.d_ff
    if cfg.mlp_variant in ("swiglu", "geglu"):
        return {
            "wi_gate": dense_init(gen, (*stack, d, f), fan_in=d, dtype=dtype),
            "wi_up": dense_init(gen, (*stack, d, f), fan_in=d, dtype=dtype),
            "wo": dense_init(gen, (*stack, f, cfg.d_model), fan_in=f, dtype=dtype),
        }
    return {
        "wi": dense_init(gen, (*stack, d, f), fan_in=d, dtype=dtype),
        "wo": dense_init(gen, (*stack, f, cfg.d_model), fan_in=f, dtype=dtype),
    }


def _act(cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_variant == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu(approximate=True)


def mlp(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The MLP on x (..., d); with column-sharded weights, this rank's
    row-parallel share (``tp.reduce(.., d_ff)`` sums the shares)."""
    dt = x.dtype
    if "wi_gate" in params:
        g = _act(cfg, x @ params["wi_gate"].to(dt))
        u = x @ params["wi_up"].to(dt)
        return (g * u) @ params["wo"].to(dt)
    h = _act(cfg, x @ params["wi"].to(dt))
    return h @ params["wo"].to(dt)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def moe_init(gen, cfg, dtype=torch.float32, *, stack: tuple = ()) -> Params:
    """Router and expert weights on ``gen``'s device; ``stack`` prepends a
    leading shape."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, (*stack, d, e), fan_in=d, dtype=dtype),
        "wi_gate": dense_init(gen, (*stack, e, d, f), fan_in=d, dtype=dtype),
        "wi_up": dense_init(gen, (*stack, e, d, f), fan_in=d, dtype=dtype),
        "wo": dense_init(gen, (*stack, e, f, d), fan_in=f, dtype=dtype),
    }


def moe_capacity(cfg, tokens: int) -> int:
    """Per-expert capacity over a token group."""
    cap = int(tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)  # round up to 8


def moe_drop_count(params: Params, x: torch.Tensor, cfg,
                   real: torch.Tensor | None = None) -> torch.Tensor:
    """The assignments :func:`moe_block` drops past :func:`moe_capacity` on
    x (B, S, d), each lane one routing group, counting only the tokens that
    ``real`` (B, S) marks (all when None): a 0-d tensor on x's device.  A
    lane's unmarked tokens must come after its marked ones, as a serving
    step's pad entries do, so that they never displace one."""
    _, _, top_e = _route(params, x, cfg.experts_per_token)
    hits = F.one_hot(top_e, cfg.n_experts)  # (B, S, k, E)
    if real is not None:
        hits = hits * real[:, :, None, None]
    return (hits.sum(dim=(1, 2)) - moe_capacity(cfg, x.shape[1])).clamp_min(0).sum()


def _route(params: Params, x: torch.Tensor, k: int) -> tuple:
    """(probs, top_p, top_e) over the last axis of ``x``'s router logits:
    the logits in ``x``'s dtype, then fp32; the top ``k`` experts with the
    lower index first among equal probabilities (``jax.lax.top_k``'s order,
    which ``torch.topk`` does not promise), their probabilities renormalised
    over the k."""
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    return probs, top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9), top_e


def moe_block(params: Params, x: torch.Tensor, cfg, seq: int | None = None) -> tuple:
    """x: (B, S, d) -> (y, aux_loss).  ``seq``: S's global size when ``x``
    is this rank's S slice of a sequence-parallel stream: S is gathered
    before the routing, which sees every position, and ``y`` is this
    rank's slice.

    Group-local capacity-bounded dispatch (GShard semantics): each batch row
    is a routing group, so positions and capacity are computed per group
    with a sequence-long cumsum over the assignments in token-major order
    (token t's k choices, then token t+1's).  Over-capacity assignments
    drop (capacity_factor 1.25): they land in a scratch slot at index
    ``cap``, which is sliced off and reads 0 on the way back, and their
    weight is not renormalised away.
    """
    x = tp.gather_seq(x, seq)  # the router reads it whole
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token

    # each span's CUDA events cost the card's host ~15 us a record: a
    # serving step, paced by its host, times them on the host alone
    dev = x.device if torch.is_grad_enabled() else None
    with timing.span("moe.route", device=dev):
        probs, top_p, top_e = _route(params, x, k)  # (B, S, E), (B, S, k) x 2

        # load-balancing aux loss (Switch-style), computed globally
        me = batch_mean(probs.mean(dim=(0, 1)))  # (E,)
        ce = batch_mean(F.one_hot(top_e, e).float().sum(dim=(0, 1, 2)) / (b * s * k))
        aux = e * torch.sum(me * ce)

    cap = moe_capacity(cfg, s)
    expert_parallel = getattr(cfg, "moe_shard", "expert") == "expert"
    split = e if expert_parallel else cfg.d_ff  # the dim the experts' work is split on
    lo, hi = tp.local_range(e) if expert_parallel else (0, e)  # this rank's experts
    x, top_p = tp.copy(x, split), tp.copy(top_p, split)  # the combine branch
    with timing.span("moe.dispatch", device=dev):
        flat_e = top_e.reshape(b, s * k)  # (B, S*k) expert id per assignment
        onehot = F.one_hot(flat_e, e)  # (B, S*k, E)
        pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)  # slot within (group, expert)
        keep = pos < cap
        dump = torch.where(keep, pos, cap)  # dropped -> scratch slot `cap`

        # scatter the token per assignment into (B, E, C+1, d); only the
        # scratch slot can take two writes, and it is sliced off
        group = torch.arange(b, device=x.device)[:, None]
        buf = torch.zeros((b, e, cap + 1, d), dtype=dt, device=x.device)
        buf[group, flat_e, dump] = x.repeat_interleave(k, dim=1)
        buf = buf[:, lo:hi, :cap]  # (B, E_local, C, d)

    with timing.span("moe.experts", device=dev):
        g = _act(cfg, torch.einsum("becd,edf->becf", buf, params["wi_gate"].to(dt)))
        u = torch.einsum("becd,edf->becf", buf, params["wi_up"].to(dt))
        out = torch.einsum("becf,efd->becd", g * u, params["wo"].to(dt))  # (B, E_local, C, d)

    with timing.span("moe.combine", device=dev):
        out = F.pad(out, (0, 0, 0, 1, lo, e - hi))  # the scratch slot, other ranks' experts: 0
        gathered = out[group, flat_e, dump].reshape(b, s, k, d)
        w = (top_p * keep.reshape(b, s, k)).to(dt)  # (B, S, k)
        y = torch.einsum("bskd,bsk->bsd", gathered, w)
    return tp.reduce_seq(y, split, seq), aux


def moe_block_dense(params: Params, x: torch.Tensor, cfg) -> tuple:
    """Reference MoE: every token through every expert, mask-combined.

    O(T * E * d * f) compute, exact (no drops): the oracle when capacity is
    ample.
    """
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    xf = x.reshape(-1, d)
    probs, top_p, top_e = _route(params, xf, k)
    comb = torch.zeros_like(probs).scatter_(1, top_e, top_p)

    g = _act(cfg, torch.einsum("td,edf->tef", xf, params["wi_gate"].to(dt)))
    u = torch.einsum("td,edf->tef", xf, params["wi_up"].to(dt))
    o = torch.einsum("tef,efd->ted", g * u, params["wo"].to(dt))
    y = torch.einsum("ted,te->td", o, comb.to(dt))

    me = batch_mean(probs.mean(dim=0))
    ce = batch_mean(F.one_hot(top_e.reshape(-1), e).float().sum(dim=0) / top_e.numel())
    aux = e * torch.sum(me * ce)
    return y.reshape(b, s, d), aux
