"""Mamba2 (SSD — state-space dual) blocks + the Zamba2 hybrid LM.

Port of ``repro.models.mamba``.  Chunked SSD: within-chunk parallel
(decay-masked C·B scores) + cross-chunk state scan; exact single-step
recurrence for decode.  ``cfg.ssm_impl == "pallas"`` (the reference's name)
runs the stateless full-sequence scan through ``kernels.api.ssm_scan``, which
launches the hand-written CUDA kernel on CUDA tensors and takes its plain
version on CPU tensors; stateful calls use the plain ``ssd_chunked``.

Zamba2 layout (see configs/zamba2_7b.py): 13 super-units of [shared-attn +
6 Mamba2 layers] + tail [shared-attn + 3 Mamba2 layers] = 81 SSM layers, 14
shared-attention applications.  Parameters are stacked as the reference's
``vmap`` gives them (``supers`` leaves lead with ``(n_super, per)``, ``tail``
leaves with ``(tail,)``); the layers run as Python loops over those axes.
The reference's sharding pins are left out; each Mamba2 residual layer of
the full-sequence forward is checkpointed (``common.remat``) when
``cfg.remat`` is set and grad is enabled, as the reference's.

Under a tensor-parallel mesh (``dist.activation_sharding``, params placed by
``dist.param_specs``) the rule splits ``w_in`` on its columns (so each rank
holds the heads [lo, hi) of ``d_in = H·P``), ``w_out`` on its rows (summed
over the ranks), ``lm_head`` and ``embed`` on the vocab and the shared
block's ``wq``/``wk``/``wv``/``wo`` on the heads; every other Mamba2 leaf
(``w_z``, ``w_bc``, ``w_dt``, ``dt_bias``, ``A_log``, ``D``, ``conv_w``,
``conv_b``, ``out_norm``) and the shared block's MLP and norms stay whole.
A rank reads its heads' part of each whole leaf, and the B/C channels whole,
after ``tp.copy``; ``out_norm``, an RMSNorm over all of ``d_in``, sums its
squares over the ranks (``tp.sum_split``).  The scan runs on the local
heads.  The decode step gathers the step's local ``x @ w_in`` columns and
updates the whole state on every rank (the cache's SSM and conv state are
whole, as the rule lays them); only ``w_out``'s partial is summed.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.core import timing
from repro_torch.dist import tensor_parallel as tp

from ..kernels.ref import ssd_chunked_ref
from . import attention as attn
from . import mlp as mlps
from .common import (
    Params,
    as_dtype,
    dense_init,
    embed_init,
    remat,
    rmsnorm,
    rmsnorm_init,
    softmax_xent,
    token_positions,
)
from .transformer import embed_tokens, layer_list


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
def mamba_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, n_heads, conv_dim


def mamba_init(gen: torch.Generator, cfg, dtype=torch.float32, *, stack: tuple = ()) -> Params:
    """Mamba2 weights on ``gen``'s device; ``stack`` prepends a leading shape."""
    d, dev = cfg.d_model, gen.device
    d_in, h, conv_dim = mamba_dims(cfg)
    n = cfg.ssm_state
    conv_w = torch.empty((*stack, cfg.ssm_conv_width, conv_dim), device=dev)
    conv_w.normal_(generator=gen).mul_(0.1)
    return {
        "norm": rmsnorm_init(d, dtype, stack=stack, device=dev),
        "w_in": dense_init(gen, (*stack, d, d_in), fan_in=d, dtype=dtype),
        "w_z": dense_init(gen, (*stack, d, d_in), fan_in=d, dtype=dtype),
        "w_bc": dense_init(gen, (*stack, d, 2 * n), fan_in=d, dtype=dtype),
        "w_dt": dense_init(gen, (*stack, d, h), fan_in=d, dtype=dtype),
        "dt_bias": torch.zeros((*stack, h), dtype=dtype, device=dev),
        "A_log": torch.zeros((*stack, h), dtype=dtype, device=dev),  # A = -exp(A_log) = -1
        "D": torch.ones((*stack, h), dtype=dtype, device=dev),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((*stack, conv_dim), dtype=dtype, device=dev),
        "out_norm": rmsnorm_init(d_in, dtype, stack=stack, device=dev),
        "w_out": dense_init(gen, (*stack, d_in, d), fan_in=d_in, dtype=dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no linear cutoff."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xw: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  xw (B,S,C), w (W,C).  The reference's sum of
    W shifted products, not ``F.conv1d`` (cuDNN would run fp32 in TF32)."""
    width = w.shape[0]
    pad = F.pad(xw, (0, 0, width - 1, 0))
    s = xw.shape[1]
    out = sum(pad[:, i : i + s, :] * w[i] for i in range(width))
    return F.silu(out + b)


def _conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Single-token conv.  x_t (B,C); conv_state (B,W-1,C)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B,W,C)
    out = torch.einsum("bwc,wc->bc", window, w)
    return F.silu(out + b), window[:, 1:, :]


def ssd_chunked(u, a_log, B_, C_, h0, chunk: int):
    """Chunked SSD scan (plain torch): ``kernels.ref.ssd_chunked_ref``, the
    ssm_scan kernel's plain passes composed, around S zero-padded to a
    multiple of ``chunk`` (a_log 0 is a decay of 1 and u, B, C 0 add
    nothing, so the final state is the one after step S).

    u (B,S,H,P) dt-scaled inputs; a_log (B,S,H) per-step log decay (<=0);
    B_/C_ (B,S,N); h0 (B,H,P,N).  Returns (y (B,S,H,P), h_final).
    """
    s = u.shape[1]
    pad = -s % chunk
    if pad:
        u = F.pad(u, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    y, h_final = ssd_chunked_ref(u, a_log, B_, C_, chunk, h0)
    return y[:, :s].to(u.dtype), h_final


def local_heads(cfg) -> tuple:
    """This rank's [lo, hi) of the Mamba2 heads: those of its columns of
    ``w_in`` (all of them when the rule keeps ``d_in`` whole)."""
    d_in, _, _ = mamba_dims(cfg)
    lo, hi = tp.local_range(d_in)
    pd = cfg.ssm_head_dim
    if lo % pd or hi % pd:
        raise ValueError(f"the `model` axis splits d_in={d_in} inside a head of {pd} channels")
    return lo // pd, hi // pd


def _part(leaf: torch.Tensor, d_in: int, lo: int, hi: int) -> torch.Tensor:
    """A whole leaf's last-dim [lo, hi), read by this rank's heads (its
    gradient, partial on each rank, summed over them)."""
    return tp.copy(leaf, d_in)[..., lo:hi]


def _conv_part(leaf: torch.Tensor, d_in: int, lo: int, hi: int) -> torch.Tensor:
    """The conv's channels this rank reads of a whole ``conv_w``/``conv_b``:
    its heads' ``x`` channels and every B/C channel."""
    if (lo, hi) == (0, d_in):
        return leaf
    leaf = tp.copy(leaf, d_in)
    return torch.cat([leaf[..., lo:hi], leaf[..., d_in:]], dim=-1)


def _out_norm(p: Params, y: torch.Tensor, cfg, d_in: int, lo: int, hi: int) -> torch.Tensor:
    """``rmsnorm(p["out_norm"], y)`` over all of ``d_in``, y holding this
    rank's channels [lo, hi): the sum of squares summed over the ranks."""
    if (lo, hi) == (0, d_in):
        return rmsnorm(p["out_norm"], y, cfg.norm_eps)
    dt = y.dtype
    y32 = y.float()
    var = tp.sum_split(y32.square().sum(dim=-1, keepdim=True), d_in) / d_in
    scale = _part(p["out_norm"]["scale"], d_in, lo, hi)
    return (y32 * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(dt)


def mamba_forward(p: Params, x: torch.Tensor, cfg, h0=None, return_state: bool = False):
    """Full-sequence Mamba2 block (no residual).  x (B,S,d).

    ``cfg.ssm_impl == "pallas"`` routes the scan through the dispatch-API
    kernel; stateful calls (``h0`` given or ``return_state=True``) always use
    the plain chunked scan — the kernel has no initial/final-state interface.
    Under a tensor-parallel mesh the block runs on this rank's heads (``h0``
    and the returned state hold them) and the output is summed over the
    ranks.
    """
    bsz, s, _ = x.shape
    d_in, _, _ = mamba_dims(cfg)
    n, pd = cfg.ssm_state, cfg.ssm_head_dim
    dt = x.dtype
    h_lo, h_hi = local_heads(cfg)
    lo, hi, h = h_lo * pd, h_hi * pd, h_hi - h_lo

    xs = tp.copy(x, d_in)  # into this rank's heads
    xin = xs @ p["w_in"].to(dt)
    z = xs @ _part(p["w_z"], d_in, lo, hi).to(dt)
    bc = tp.copy(x @ p["w_bc"].to(dt), d_in)  # whole, read by every rank's heads
    dt_raw = ((xs @ _part(p["w_dt"], d_in, h_lo, h_hi).to(dt)).float()
              + _part(p["dt_bias"], d_in, h_lo, h_hi).float())
    delta = _softplus(dt_raw)  # (B,S,H)

    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out = _causal_conv(conv_in, _conv_part(p["conv_w"], d_in, lo, hi).to(dt),
                            _conv_part(p["conv_b"], d_in, lo, hi).to(dt))
    xin, b_, c_ = torch.split(conv_out, [hi - lo, n, n], dim=-1)

    xh = xin.reshape(bsz, s, h, pd)
    a_log = -torch.exp(_part(p["A_log"], d_in, h_lo, h_hi).float())[None, None] * delta
    u = xh * delta.to(dt)[..., None]

    if cfg.ssm_impl == "pallas" and h0 is None and not return_state:
        # dispatch-API kernel path: head-shared B/C layout matches directly;
        # the kernel owns chunking/padding and starts from a zero state
        from repro_torch.kernels import api

        with timing.span("mamba.scan.kernel", device=x.device):
            y = api.ssm_scan(u, a_log, b_, c_, chunk=cfg.ssm_chunk)
        h_final = None
    else:
        if h0 is None:
            h0 = torch.zeros((bsz, h, pd, n), dtype=torch.float32, device=x.device)
        with timing.span("mamba.scan.plain", device=x.device):
            y, h_final = ssd_chunked(u, a_log, b_, c_, h0, cfg.ssm_chunk)
    y = y + xh * _part(p["D"], d_in, h_lo, h_hi).to(dt)[None, None, :, None]
    y = y.reshape(bsz, s, hi - lo)
    y = _out_norm(p, y, cfg, d_in, lo, hi) * F.silu(z)
    out = tp.reduce(y @ p["w_out"].to(dt), d_in)
    if return_state:
        return out, h_final
    return out


def mamba_decode(p: Params, x: torch.Tensor, cfg, ssm_state, conv_state):
    """Single-token Mamba2 step.  x (B,d); returns (y, ssm_state, conv_state).

    Under a tensor-parallel mesh this rank's columns of ``x @ w_in`` are
    gathered and the step runs whole (the states are whole on every rank);
    ``w_out``'s rows, this rank's channels, give a partial summed over the
    ranks."""
    bsz, _ = x.shape
    d_in, h, _ = mamba_dims(cfg)
    n, pd = cfg.ssm_state, cfg.ssm_head_dim
    dt = x.dtype
    h_lo, h_hi = local_heads(cfg)

    xin = tp.gather(tp.copy(x, d_in) @ p["w_in"].to(dt), d_in, -1)
    z = x @ p["w_z"].to(dt)
    bc = x @ p["w_bc"].to(dt)
    delta = _softplus((x @ p["w_dt"].to(dt)).float() + p["dt_bias"].float())  # (B,H)

    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, conv_state = _conv_step(conv_in, conv_state, p["conv_w"].to(dt), p["conv_b"].to(dt))
    xin, b_, c_ = torch.split(conv_out, [d_in, n, n], dim=-1)

    xh = xin.reshape(bsz, h, pd).float()
    decay = torch.exp(-torch.exp(p["A_log"].float())[None] * delta)  # (B,H)
    u = xh * delta[..., None]
    ssm_state = ssm_state * decay[..., None, None] + torch.einsum("bn,bhp->bhpn", b_.float(), u)
    y = torch.einsum("bn,bhpn->bhp", c_.float(), ssm_state)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(bsz, d_in).to(dt)
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps) * F.silu(z)
    y = tp.copy(y, d_in)[:, h_lo * pd:h_hi * pd]  # this rank's rows of w_out
    return tp.reduce(y @ p["w_out"].to(dt), d_in), ssm_state, conv_state


# ---------------------------------------------------------------------------
# Zamba2 hybrid LM
# ---------------------------------------------------------------------------
def _zamba_counts(cfg):
    """(n_super, mamba_per_super, tail_layers)."""
    per = cfg.macro_size * cfg.attn_every_k_macro  # 6
    n_super = cfg.n_layers // per  # 13
    tail = cfg.n_layers - n_super * per  # 3
    return n_super, per, tail


def _shared_attn_init(gen, cfg, dtype) -> Params:
    """Shared transformer block taking concat(x, x0) = 2d input."""
    return {
        "norm": rmsnorm_init(2 * cfg.d_model, dtype, device=gen.device),
        "attn": attn.attn_init(gen, cfg, d_in=2 * cfg.d_model, dtype=dtype),
        "mlp_norm": rmsnorm_init(cfg.d_model, dtype, device=gen.device),
        "mlp": mlps.mlp_init(gen, cfg, dtype=dtype),
    }


def zamba_init(gen: torch.Generator, cfg) -> Params:
    """Fresh params on ``gen``'s device, stacked as the reference's."""
    dtype = as_dtype(cfg.param_dtype)
    n_super, per, tail = _zamba_counts(cfg)
    p = {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
        "supers": mamba_init(gen, cfg, dtype, stack=(n_super, per)),
        "shared_attn": _shared_attn_init(gen, cfg, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device=gen.device),
        "lm_head": embed_init(gen, (cfg.d_model, cfg.padded_vocab), dtype),
    }
    if tail:
        p["tail"] = mamba_init(gen, cfg, dtype, stack=(tail,))
    return p


def _units(params: Params, cfg) -> list:
    """The Mamba2 layers' params in order, one list per shared-attention
    application (its KV-cache slot is the list's index): the super-units,
    then the tail.  Each layer's params are views into the stacked tensors."""
    n_super, per, tail = _zamba_counts(cfg)
    units = [layer_list(sup) for sup in layer_list(params["supers"])]
    if tail:
        units.append(layer_list(params["tail"]))
    return units


def _shared_attn_apply(cfg, p: Params, x, x0, positions):
    cat = torch.cat([x, x0], dim=-1)
    h = attn.attention_block(
        p["attn"], rmsnorm(p["norm"], cat, cfg.norm_eps), cfg, positions, causal=True
    )
    x = x + h
    return x + mlps.mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)


def _shared_attn_decode(cfg, p: Params, x, x0, ck, cv, pos):
    cat = torch.cat([x, x0], dim=-1)
    h, ck, cv = attn.decode_attention(
        p["attn"], rmsnorm(p["norm"], cat, cfg.norm_eps), cfg, ck, cv, pos
    )
    x = x + h
    x = x + mlps.mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
    return x, ck, cv


def _mamba_residual(cfg, p, x):
    return x + mamba_forward(p, rmsnorm(p["norm"], x, cfg.norm_eps), cfg)


def zamba_forward(params: Params, tokens: torch.Tensor, cfg):
    """tokens (B,S) -> logits (B,S,V)."""
    x = embed_tokens(params, tokens, cfg)
    x0 = x
    b, s, _ = x.shape
    positions = token_positions(b, s, x.device)
    mamba_res = remat(partial(_mamba_residual, cfg), cfg)
    for layers in _units(params, cfg):
        x = _shared_attn_apply(cfg, params["shared_attn"], x, x0, positions)
        for lp in layers:
            x = mamba_res(lp, x)
    return zamba_logits(params, rmsnorm(params["final_norm"], x, cfg.norm_eps), cfg)


def zamba_logits(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (..., d) after the final norm -> logits (..., V): a vocab-split
    ``lm_head``'s local logits gathered (no pad slot is masked, as the
    reference's head masks none)."""
    x = tp.copy(x, cfg.padded_vocab)
    logits = torch.einsum("...d,dv->...v", x, params["lm_head"].to(x.dtype))
    return tp.gather(logits, cfg.padded_vocab, -1)


def zamba_loss(params: Params, batch: dict, cfg) -> torch.Tensor:
    """Mean token cross-entropy."""
    logits = zamba_forward(params, batch["tokens"], cfg)
    return softmax_xent(logits, batch["targets"]).mean()


# --- serving -----------------------------------------------------------------
def zamba_init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    """Zeroed decode state: the shared attention's KV per application, and
    each Mamba2 layer's SSM state (fp32) and last W-1 conv inputs."""
    n_super, _, tail = _zamba_counts(cfg)
    _, h, conv_dim = mamba_dims(cfg)
    n_attn = n_super + (1 if tail else 0)
    kv = (n_attn, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, h, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "x0": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
    }


def zamba_cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """The cache's shapes and dtypes on the ``meta`` device (no storage)."""
    return zamba_init_cache(cfg, batch, max_len, dtype, device="meta")


def _mamba_step(cfg, lp, x, s_st, c_st):
    xin = rmsnorm(lp["norm"], x, cfg.norm_eps)
    y, s_new, c_new = mamba_decode(lp, xin, cfg, s_st, c_st)
    return x + y, s_new, c_new


def zamba_decode_step(params: Params, cache: dict, tokens: torch.Tensor, pos: torch.Tensor, cfg):
    """One decode step.  tokens (B,) int, pos (B,) int -> (logits (B,V), cache).
    x0 (the residual embedding stream) is the current token's embedding.  The
    cache passed in is left as it was; the returned one is new."""
    x = embed_tokens(params, tokens, cfg)
    x0 = x  # zamba concatenates the original embedding stream
    ks, vs, ssm, conv = [], [], [], []
    li = 0
    for slot, layers in enumerate(_units(params, cfg)):
        x, ck, cv = _shared_attn_decode(cfg, params["shared_attn"], x, x0,
                                        cache["k"][slot], cache["v"][slot], pos)
        ks.append(ck)
        vs.append(cv)
        for lp in layers:
            x, s_new, c_new = _mamba_step(cfg, lp, x, cache["ssm"][li], cache["conv"][li])
            ssm.append(s_new)
            conv.append(c_new)
            li += 1
    logits = zamba_logits(params, rmsnorm(params["final_norm"], x[:, None], cfg.norm_eps)[:, 0],
                          cfg)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "ssm": torch.stack(ssm),
             "conv": torch.stack(conv), "x0": x0}
    return logits, cache
