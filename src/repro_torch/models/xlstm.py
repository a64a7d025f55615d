"""xLSTM LM: mLSTM (matrix-memory, chunkwise-parallel) + sLSTM (scalar-memory,
sequential) blocks, arranged as macro-blocks of (7 mLSTM + 1 sLSTM).

Port of ``repro.models.xlstm``.  mLSTM uses the exponentially-gated
linear-attention form with running-max stabilisation (exponents clipped at
``MCLIP``), computed chunkwise; decode is the exact single-step recurrence.
The sLSTM is a sequential scan, a Python loop over the sequence here as the
reference's is a ``lax.scan``.  Both block types use a shared gated-FFN
sub-layer (the reference's simplification of the paper).  Parameters are
stacked as the reference's ``vmap`` gives them (``macros/mlstm`` leaves lead
with ``(n_macros, mlstm_per_macro)``, ``macros/slstm`` leaves with
``(n_macros,)``); the layers run as Python loops over those axes, each block
checkpointed (``common.remat``) when ``cfg.remat`` is set and grad is
enabled.  The family reaches no kernel: it is plain torch, as the reference
is plain jnp.  Its cache is each layer's final recurrent state, so the
serving engine (which needs ``decode_chunk``) refuses it, as the
reference's does.

Under a tensor-parallel mesh only ``embed`` and ``lm_head`` split (on the
vocab): no block leaf matches a rule of ``dist.param_specs``, so the blocks
and their recurrent state are whole on every rank, and ``prefill`` returns
the whole cache.  (``dist.cache_shardings`` would put xlstm-1.3b's ``mn``
on ``model``, its head dim matching ``n_kv_heads`` = 4 by coincidence; no
engine places this family's cache.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor_parallel as tp

from .common import (
    Params,
    as_dtype,
    dense_init,
    embed_init,
    remat,
    rmsnorm,
    rmsnorm_init,
    softmax_xent,
)
from .transformer import embed_tokens, layer_list

MCLIP = 60.0


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: at a tie the gradient splits evenly between the
    two (``torch.clamp_min`` would pass all of it to ``x``)."""
    return torch.maximum(x, x.new_tensor(c))


def _clip_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp(jnp.clip(x, -MCLIP, 0))``, ties included: the stabiliser puts
    an exponent exactly at 0, where ``jnp.clip``'s minimum splits the
    gradient."""
    return torch.exp(torch.minimum(_max(x, -MCLIP), x.new_tensor(0.0)))


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------
def mlstm_init(gen, cfg, dtype=torch.float32, *, stack: tuple = ()) -> Params:
    d, h, dev = cfg.d_model, cfg.n_heads, gen.device
    bias = torch.cat([torch.zeros((*stack, h), dtype=dtype, device=dev),
                      torch.full((*stack, h), 3.0, dtype=dtype, device=dev)], dim=-1)
    return {
        "norm": rmsnorm_init(d, dtype, stack=stack, device=dev),
        "w_qkv": dense_init(gen, (*stack, d, 3 * d), fan_in=d, dtype=dtype),
        "w_gates": dense_init(gen, (*stack, d, 2 * h), fan_in=d, dtype=dtype),
        "gate_bias": bias,
        "ffn_norm": rmsnorm_init(d, dtype, stack=stack, device=dev),
        "w_up": dense_init(gen, (*stack, d, 4 * d), fan_in=d, dtype=dtype),
        "w_down": dense_init(gen, (*stack, 2 * d, d), fan_in=2 * d, dtype=dtype),
    }


def _mlstm_qkvif(p, x, cfg):
    dt = x.dtype
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    qkv = x @ p["w_qkv"].to(dt)
    q, k, v = qkv.chunk(3, dim=-1)
    q = q.reshape(b, s, h, hd) * (hd**-0.5)
    k = k.reshape(b, s, h, hd)
    v = v.reshape(b, s, h, hd)
    gates = (x @ p["w_gates"].to(dt)).float() + p["gate_bias"].float()
    i_raw, f_raw = gates.chunk(2, dim=-1)  # (B,S,H)
    return q, k, v, i_raw, F.logsigmoid(f_raw)


def mlstm_chunked(q, k, v, i_raw, log_f, state, chunk: int):
    """Chunkwise stabilized mLSTM.

    q,k,v (B,S,H,hd); i_raw/log_f (B,S,H); state = (C (B,H,hd,hd), n (B,H,hd),
    m (B,H)) fp32.  Returns (y (B,S,H,hd), state).
    """
    b, s, h, hd = q.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    tri = tri[None, :, :, None]
    C, n, m = state
    ys = []
    for j in range(nc):
        sl = slice(j * chunk, (j + 1) * chunk)
        q32, k32, v32 = (a[:, sl].float() for a in (q, k, v))
        i_j, f_j = i_raw[:, sl], log_f[:, sl]
        Fc = torch.cumsum(f_j, dim=1)  # (B,L,H)
        F_tot = Fc[:, -1]  # (B,H)
        b_t = Fc + m[:, None]  # inter log-scale
        # intra log weights D_ts = F_t - F_s + i_s
        D = Fc[:, :, None, :] - Fc[:, None, :, :] + i_j[:, None, :, :]  # (B,L,M,H)
        D = torch.where(tri, D, -torch.inf)
        m_t = torch.maximum(b_t, D.amax(dim=2))
        m_t = _max(m_t, -MCLIP)  # keep denominators sane
        Dw = torch.where(tri, _clip_exp(D - m_t[:, :, None, :]), 0.0)
        qk = torch.einsum("blhx,bmhx->blmh", q32, k32)
        Sw = qk * Dw  # (B,L,M,H)
        y_intra = torch.einsum("blmh,bmhx->blhx", Sw, v32)
        inter_scale = _clip_exp(b_t - m_t)  # (B,L,H)
        y_inter = torch.einsum("blhx,bhxy->blhy", q32, C) * inter_scale[..., None]
        norm = Sw.sum(dim=2) + torch.einsum("blhx,bhx->blh", q32, n) * inter_scale
        denom = torch.maximum(norm.abs(), torch.exp(-m_t))
        ys.append((y_intra + y_inter) / denom[..., None])
        # state update
        s_log = F_tot[:, None, :] - Fc + i_j  # (B,L,H): decay from s to chunk end
        m_new = torch.maximum(F_tot + m, s_log.amax(dim=1))
        m_new = _max(m_new, -MCLIP)
        state_scale = _clip_exp(F_tot + m - m_new)
        in_w = _clip_exp(s_log - m_new[:, None, :])
        C = C * state_scale[:, :, None, None] + torch.einsum("blhx,blhy,blh->bhxy", k32, v32,
                                                             in_w)
        n = n * state_scale[..., None] + torch.einsum("blhx,blh->bhx", k32, in_w)
        m = m_new
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(q.dtype), (C, n, m)


def mlstm_step(q, k, v, i_raw, log_f, state):
    """Exact single-token mLSTM recurrence.  q,k,v (B,H,hd); gates (B,H)."""
    C, n, m = state
    q32, k32, v32 = (a.float() for a in (q, k, v))
    m_new = torch.maximum(log_f + m, i_raw)
    m_new = _max(m_new, -MCLIP)
    f_w = _clip_exp(log_f + m - m_new)
    i_w = _clip_exp(i_raw - m_new)
    C = C * f_w[..., None, None] + i_w[..., None, None] * torch.einsum("bhx,bhy->bhxy", k32, v32)
    n = n * f_w[..., None] + i_w[..., None] * k32
    y = torch.einsum("bhx,bhxy->bhy", q32, C)
    denom = torch.maximum(torch.einsum("bhx,bhx->bh", q32, n).abs(), torch.exp(-m_new))
    y = y / denom[..., None]
    return y.to(q.dtype), (C, n, m_new)


def _ffn(p, x, cfg):
    dt = x.dtype
    g, u = (x @ p["w_up"].to(dt)).chunk(2, dim=-1)
    return (F.silu(g) * u) @ p["w_down"].to(dt)


def mlstm_block(p: Params, x: torch.Tensor, cfg, state=None, return_state: bool = False):
    b, s, d = x.shape
    h, hd = cfg.n_heads, d // cfg.n_heads
    if state is None:
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=x.device)  # noqa: E731
        state = (z(b, h, hd, hd), z(b, h, hd), z(b, h))
    xin = rmsnorm(p["norm"], x, cfg.norm_eps)
    q, k, v, i_raw, log_f = _mlstm_qkvif(p, xin, cfg)
    y, state = mlstm_chunked(q, k, v, i_raw, log_f, state, cfg.ssm_chunk)
    x = x + y.reshape(b, s, d)
    x = x + _ffn(p, rmsnorm(p["ffn_norm"], x, cfg.norm_eps), cfg)
    if return_state:
        return x, state
    return x


def mlstm_block_decode(p: Params, x: torch.Tensor, cfg, state):
    """x (B,d)."""
    b, d = x.shape
    xin = rmsnorm(p["norm"], x[:, None], cfg.norm_eps)
    q, k, v, i_raw, log_f = _mlstm_qkvif(p, xin, cfg)
    y, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], log_f[:, 0], state)
    x = x + y.reshape(b, d)
    x = x + _ffn(p, rmsnorm(p["ffn_norm"], x[:, None], cfg.norm_eps), cfg)[:, 0]
    return x, state


# ---------------------------------------------------------------------------
# sLSTM cell (sequential scan; few layers)
# ---------------------------------------------------------------------------
def slstm_init(gen, cfg, dtype=torch.float32, *, stack: tuple = ()) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    hd, dev = d // h, gen.device
    bias = torch.cat([torch.zeros((*stack, 2 * d), dtype=dtype, device=dev),
                      torch.full((*stack, d), 3.0, dtype=dtype, device=dev),
                      torch.zeros((*stack, d), dtype=dtype, device=dev)], dim=-1)
    r = torch.randn((*stack, 4, h, hd, hd), generator=gen, dtype=torch.float32, device=dev)
    return {
        "norm": rmsnorm_init(d, dtype, stack=stack, device=dev),
        "w_x": dense_init(gen, (*stack, d, 4 * d), fan_in=d, dtype=dtype),
        "bias": bias,
        "r": r.mul_(0.1).to(dtype),
        "ffn_norm": rmsnorm_init(d, dtype, stack=stack, device=dev),
        "w_up": dense_init(gen, (*stack, d, 4 * d), fan_in=d, dtype=dtype),
        "w_down": dense_init(gen, (*stack, 2 * d, d), fan_in=2 * d, dtype=dtype),
    }


def _slstm_scan(p, xg, cfg, state):
    """xg: (B,S,4d) precomputed input projections (+bias).  Sequential scan;
    state = (c, n, m, h), each (B,H,hd) fp32.  Returns (y (B,S,d) fp32,
    state)."""
    b, s, _ = xg.shape
    d = cfg.d_model
    h, hd = cfg.n_heads, d // cfg.n_heads
    r = p["r"].float()
    c, n, m, hprev = state
    ys = []
    for t in range(s):
        rec = torch.einsum("bhx,ghxy->gbhy", hprev, r)  # (4,B,H,hd)
        zt, it, ft, ot = xg[:, t].reshape(b, 4, h, hd).transpose(0, 1).float() + rec
        z = torch.tanh(zt)
        o = torch.sigmoid(ot)
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        m_new = _max(m_new, -MCLIP)
        f_w = _clip_exp(log_f + m - m_new)
        i_w = _clip_exp(it - m_new)
        c = f_w * c + i_w * z
        n = f_w * n + i_w
        hprev = o * c / _max(n, 1.0)
        m = m_new
        ys.append(hprev)
    return torch.stack(ys, dim=1).reshape(b, s, d), (c, n, m, hprev)


def slstm_zero_state(cfg, batch: int, device):
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    z = torch.zeros((batch, h, hd), dtype=torch.float32, device=device)
    return (z, z, z, z)


def slstm_block(p: Params, x: torch.Tensor, cfg, state=None, return_state: bool = False):
    b, s, d = x.shape
    if state is None:
        state = slstm_zero_state(cfg, b, x.device)
    xin = rmsnorm(p["norm"], x, cfg.norm_eps)
    xg = xin @ p["w_x"].to(x.dtype) + p["bias"].to(x.dtype)
    y, state = _slstm_scan(p, xg, cfg, state)
    x = x + y.to(x.dtype)
    x = x + _ffn(p, rmsnorm(p["ffn_norm"], x, cfg.norm_eps), cfg)
    if return_state:
        return x, state
    return x


def slstm_block_decode(p: Params, x: torch.Tensor, cfg, state):
    xin = rmsnorm(p["norm"], x[:, None], cfg.norm_eps)
    xg = xin @ p["w_x"].to(x.dtype) + p["bias"].to(x.dtype)
    y, state = _slstm_scan(p, xg, cfg, state)
    x = x + y[:, 0].to(x.dtype)
    x = x + _ffn(p, rmsnorm(p["ffn_norm"], x[:, None], cfg.norm_eps), cfg)[:, 0]
    return x, state


# ---------------------------------------------------------------------------
# full LM
# ---------------------------------------------------------------------------
def n_macros(cfg) -> int:
    per = cfg.xlstm_mlstm_per_macro + cfg.xlstm_slstm_per_macro
    if cfg.n_layers % per:
        raise ValueError(f"n_layers {cfg.n_layers} does not divide into macro blocks of {per}")
    return cfg.n_layers // per


def xlstm_init(gen: torch.Generator, cfg) -> Params:
    """Fresh params on ``gen``'s device, stacked as the reference's."""
    dtype = as_dtype(cfg.param_dtype)
    nm = n_macros(cfg)
    return {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
        "macros": {
            "mlstm": mlstm_init(gen, cfg, dtype, stack=(nm, cfg.xlstm_mlstm_per_macro)),
            "slstm": slstm_init(gen, cfg, dtype, stack=(nm,)),
        },
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device=gen.device),
        "lm_head": embed_init(gen, (cfg.d_model, cfg.padded_vocab), dtype),
    }


def _macros(params: Params) -> list:
    """Per macro block: (its mLSTM layers' params, its sLSTM's params), views
    into the stacked tensors."""
    mac = params["macros"]
    return list(zip((layer_list(m) for m in layer_list(mac["mlstm"])), layer_list(mac["slstm"])))


def _head(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The final norm and the head: a vocab-split ``lm_head``'s local logits
    gathered."""
    x = tp.copy(rmsnorm(params["final_norm"], x, cfg.norm_eps), cfg.padded_vocab)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(x.dtype))
    return tp.gather(logits, cfg.padded_vocab, -1)


def xlstm_forward(params: Params, tokens: torch.Tensor, cfg):
    """tokens (B,S) -> logits (B,S,V)."""
    x = embed_tokens(params, tokens, cfg)
    mblock = remat(lambda lp, x: mlstm_block(lp, x, cfg), cfg)
    sblock = remat(lambda lp, x: slstm_block(lp, x, cfg), cfg)
    for mlayers, sp in _macros(params):
        for lp in mlayers:
            x = mblock(lp, x)
        x = sblock(sp, x)
    return _head(params, x, cfg)


def xlstm_loss(params: Params, batch: dict, cfg) -> torch.Tensor:
    logits = xlstm_forward(params, batch["tokens"], cfg)
    return softmax_xent(logits, batch["targets"]).mean()


# --- serving -----------------------------------------------------------------
def xlstm_init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    """Zeroed recurrent state, fp32 (``max_len`` and ``dtype`` are unused: the
    state does not grow with the sequence)."""
    nm, nmm = n_macros(cfg), cfg.xlstm_mlstm_per_macro
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    shapes = {
        "mC": (nm, nmm, batch, h, hd, hd), "mn": (nm, nmm, batch, h, hd),
        "mm": (nm, nmm, batch, h),
        **{k: (nm, batch, h, hd) for k in ("sc", "sn", "sm", "sh")},
    }
    return {k: torch.zeros(s, dtype=torch.float32, device=device) for k, s in shapes.items()}


def xlstm_cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """The cache's shapes and dtypes on the ``meta`` device (no storage)."""
    return xlstm_init_cache(cfg, batch, max_len, dtype, device="meta")


def xlstm_prefill(params: Params, tokens: torch.Tensor, cfg):
    """Full forward collecting each layer's final recurrent state as the
    cache (the reference's ``api._xlstm_prefill``).  Returns (last_logits
    (B,V), cache)."""
    x = embed_tokens(params, tokens, cfg)
    mstates, sstates = [], []
    for mlayers, sp in _macros(params):
        acc = []
        for lp in mlayers:
            x, st = mlstm_block(lp, x, cfg, return_state=True)
            acc.append(st)
        mstates.append([torch.stack([a[j] for a in acc]) for j in range(3)])
        x, st = slstm_block(sp, x, cfg, return_state=True)
        sstates.append(st)
    logits = _head(params, x[:, -1:, :], cfg)[:, 0]
    cache = {k: torch.stack([st[j] for st in mstates]) for j, k in enumerate(("mC", "mn", "mm"))}
    cache.update({k: torch.stack([st[j] for st in sstates])
                  for j, k in enumerate(("sc", "sn", "sm", "sh"))})
    return logits, cache


def xlstm_decode_step(params: Params, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
                      cfg):
    """One decode step.  tokens (B,) int -> (logits (B,V), cache); ``pos`` is
    unused (the state carries the position).  The cache passed in is left as
    it was; the returned one is new."""
    x = embed_tokens(params, tokens, cfg)
    mstates, sstates = [], []
    for i, (mlayers, sp) in enumerate(_macros(params)):
        acc = []
        for j, lp in enumerate(mlayers):
            x, st = mlstm_block_decode(lp, x, cfg,
                                       (cache["mC"][i, j], cache["mn"][i, j], cache["mm"][i, j]))
            acc.append(st)
        mstates.append([torch.stack([a[k] for a in acc]) for k in range(3)])
        x, st = slstm_block_decode(sp, x, cfg, tuple(cache[k][i] for k in ("sc", "sn", "sm",
                                                                            "sh")))
        sstates.append(st)
    logits = _head(params, x[:, None], cfg)[:, 0]
    new = {k: torch.stack([st[j] for st in mstates]) for j, k in enumerate(("mC", "mn", "mm"))}
    new.update({k: torch.stack([st[j] for st in sstates])
                for j, k in enumerate(("sc", "sn", "sm", "sh"))})
    return logits, new
