"""Plain float32 reference of the Zamba2 hybrid as the configuration's
``model`` block sizes it: Mamba2 layers in units, each unit led by one call
of a single shared block (rotary attention over the concatenation of the
stream and the embeddings, then a GELU MLP), and its prefill's state.

The SSD scan is written here in its chunked form (exact: the within-chunk
quadratic part plus the state passed from chunk to chunk); a test holds it
against the step-by-step recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Numerics, causal_attention, gelu_tanh, rmsnorm, rope


def units(params: dict, m: dict) -> list:
    """Each shared-block call's Mamba2 layers, in order: the super-units'
    (stacked (n_super, per, ...)), then the tail's."""
    def pick(tree, *idx):
        return {k: pick(v, *idx) if isinstance(v, dict) else v[idx] for k, v in tree.items()}

    sup = params["supers"]
    n_super, per = sup["w_in"].shape[:2]
    out = [[pick(sup, i, j) for j in range(per)] for i in range(n_super)]
    if "tail" in params:
        out.append([pick(params["tail"], j) for j in range(params["tail"]["w_in"].shape[0])])
    return out


def ssd_scan(u, a, b_, c_, chunk: int) -> tuple:
    """h_t = exp(a_t) h_{t-1} + u_t (x) B_t, y_t = C_t . h_t from h_0 = 0.

    u (B,S,H,P), a (B,S,H) <= 0, b_/c_ (B,S,N) shared by the heads; S a
    multiple of ``chunk``.  Returns (y (B,S,H,P), h_S (B,H,P,N))."""
    bsz, s, h, p = u.shape
    n = b_.shape[-1]
    c = s // chunk
    u = u.reshape(bsz, c, chunk, h, p)
    a = a.reshape(bsz, c, chunk, h)
    b_ = b_.reshape(bsz, c, chunk, n)
    c_ = c_.reshape(bsz, c, chunk, n)
    acum = torch.cumsum(a, dim=2)  # (B,c,Q,H)
    seg = acum[:, :, :, None, :] - acum[:, :, None, :, :]  # (B,c,Qi,Qj,H)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=u.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", c_, b_)
    y = torch.einsum("bcij,bcijh,bcjhp->bcihp", scores, decay, u)
    to_end = torch.exp(acum[:, :, -1:, :] - acum)  # (B,c,Q,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", b_, to_end, u)
    carry = torch.exp(acum[:, :, -1, :])  # (B,c,H)
    hs = u.new_zeros(bsz, h, p, n)
    into = []
    for ci in range(c):
        into.append(hs)
        hs = hs * carry[:, ci, :, None, None] + states[:, ci]
    into = torch.stack(into, dim=1)  # (B,c,H,P,N): the state entering each chunk
    y = y + torch.einsum("bcin,bchpn,bcih->bcihp", c_, into, torch.exp(acum))
    return y.reshape(bsz, s, h, p), hs


def mamba_layer(num: Numerics, p: dict, x: torch.Tensor, m: dict) -> tuple:
    """One Mamba2 residual layer on x (B,S,d): (x, final SSM state, the
    last W-1 conv inputs)."""
    bsz, s, d = x.shape
    n, pd, width = m["ssm_state"], m["ssm_head_dim"], m["ssm_conv_width"]
    d_in = m["ssm_expand"] * d
    heads = d_in // pd
    xin = rmsnorm(x, p["norm"]["scale"], m["norm_eps"])
    xz = num.einsum("bsd,de->bse", xin, p["w_in"])
    z = num.einsum("bsd,de->bse", xin, p["w_z"])
    bc = num.einsum("bsd,de->bse", xin, p["w_bc"])
    dt = F.softplus(num.einsum("bsd,dh->bsh", xin, p["w_dt"]) + p["dt_bias"].float())
    conv_in = torch.cat([xz, bc], dim=-1)
    padded = F.pad(conv_in, (0, 0, width - 1, 0))
    w = p["conv_w"].float()
    conv = sum(padded[:, i:i + s] * w[i] for i in range(width)) + p["conv_b"].float()
    xh, b_, c_ = torch.split(F.silu(conv), [d_in, n, n], dim=-1)
    xh = xh.reshape(bsz, s, heads, pd)
    a = -torch.exp(p["A_log"].float()) * dt
    pad = -s % m["ssm_chunk"]
    u = xh * dt[..., None]
    if pad:
        u, a = F.pad(u, (0, 0, 0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad))
        b_, c_ = F.pad(b_, (0, 0, 0, pad)), F.pad(c_, (0, 0, 0, pad))
    y, h = ssd_scan(u, a, b_, c_, m["ssm_chunk"])
    y = y[:, :s] + xh * p["D"].float()[:, None]
    y = rmsnorm(y.reshape(bsz, s, d_in), p["out_norm"]["scale"], m["norm_eps"]) * F.silu(z)
    return x + num.einsum("bse,ed->bsd", y, p["w_out"]), h, conv_in[:, s - (width - 1):]


def shared_block(num: Numerics, p: dict, x, x0, m: dict, positions) -> tuple:
    """The shared block on x (B,S,d) with the embeddings x0: (x, k, v),
    k after its rotary embedding, as a cache holds them."""
    cat = rmsnorm(torch.cat([x, x0], dim=-1), p["norm"]["scale"], m["norm_eps"])
    a = p["attn"]
    q = rope(num.einsum("bsd,dhx->bshx", cat, a["wq"]), positions, m["rope_theta"])
    k = rope(num.einsum("bsd,dkx->bskx", cat, a["wk"]), positions, m["rope_theta"])
    v = num.einsum("bsd,dkx->bskx", cat, a["wv"])
    x = x + num.einsum("bshx,hxd->bsd", causal_attention(num, q, k, v), a["wo"])
    h = rmsnorm(x, p["mlp_norm"]["scale"], m["norm_eps"])
    mlp = p["mlp"]
    x = x + num.einsum("bsf,fd->bsd", gelu_tanh(num.einsum("bsd,df->bsf", h, mlp["wi"])),
                       mlp["wo"])
    return x, k, v


@torch.no_grad()
def prefill(num: Numerics, params: dict, tokens: torch.Tensor, m: dict, visit) -> torch.Tensor:
    """The forward over tokens (B,S); returns the last position's logits
    (B,V).  ``visit(kind, index, *tensors)`` receives each piece of state a
    prefill leaves as it is made: ("kv", slot, k, v) for each shared-block
    call, ("ssm", layer, h, conv_tail) for each Mamba2 layer."""
    bsz, s = tokens.shape
    x = params["embed"][tokens.long()].float()
    x0 = x
    positions = torch.arange(s, device=tokens.device).expand(bsz, s)
    li = 0
    for slot, layers in enumerate(units(params, m)):
        x, k, v = shared_block(num, params["shared_attn"], x, x0, m, positions)
        visit("kv", slot, k, v)
        del k, v
        for lp in layers:
            x, h, tail = mamba_layer(num, lp, x, m)
            visit("ssm", li, h, tail)
            li += 1
    x = rmsnorm(x[:, -1], params["final_norm"]["scale"], m["norm_eps"])
    return num.einsum("bd,dv->bv", x, params["lm_head"])
