"""GQA attention: blockwise (online softmax), naive, and the flash-kernel
path; KV-cache decode.

Port of ``repro.models.attention``.  ``blockwise_attention`` is plain torch
and runs anywhere; ``pallas_attention`` (``cfg.attn_impl == "pallas"``, the
reference's name) goes through ``kernels.api.flash_attention``, which
launches the hand-written CUDA kernel on CUDA tensors and takes its plain
version on CPU tensors.  The KV cache comes in the reference's two layouts:
dense per-lane regions and a global page pool read through block tables
(the serving engine's paged KV).

Under a tensor-parallel mesh (``dist.activation_sharding``) each rank holds
its query heads of ``wq``/``wo`` and, where the ``model`` axis divides
them, its KV heads; a replicated bias is sliced to the local heads
(:func:`local_bias`), the query heads read their global KV heads
(:func:`local_kv`), and the output projection, row-parallel, is summed over
the ranks.  Under autograd the block's input enters the split heads through
``tp.copy`` (its gradient summed over the ranks); KV heads kept whole are
projected from the input as it is and take their own ``copy`` before the
local query heads read them, since each rank's heads give them only part of
their gradient.  On the transformer's sequence-parallel stream
(``attention_block(seq=S)``) the entry gathers S and the exit
reduce-scatters it (``tp.copy_seq``/``tp.reduce_seq``); KV heads kept whole
read the gathered input whole (``tp.gather_seq``).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from repro_torch.dist import tensor_parallel as tp

from .common import Params, apply_rope, dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def attn_init(gen, cfg, d_in: int | None = None, dtype=torch.float32, *,
              stack: tuple = ()) -> Params:
    """Attention weights on ``gen``'s device; ``stack`` prepends a leading
    shape (the layer axis of a stacked model)."""
    d = d_in if d_in is not None else cfg.d_model
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (*stack, d, h, hd), fan_in=d, dtype=dtype),
        "wk": dense_init(gen, (*stack, d, k, hd), fan_in=d, dtype=dtype),
        "wv": dense_init(gen, (*stack, d, k, hd), fan_in=d, dtype=dtype),
        "wo": dense_init(gen, (*stack, h, hd, cfg.d_model), fan_in=h * hd, dtype=dtype),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", k), ("bv", k)):
            p[name] = torch.zeros((*stack, heads, hd), dtype=dtype, device=gen.device)
    return p


def qkv_proj(params: Params, x: torch.Tensor, cfg):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,K,hd)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhx->bshx", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dkx->bskx", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dkx->bskx", x, params["wv"].to(dt))
    if "bq" in params:
        q = q + local_bias(params["bq"], cfg.n_heads).to(dt)
        k = k + local_bias(params["bk"], cfg.n_kv_heads).to(dt)
        v = v + local_bias(params["bv"], cfg.n_kv_heads).to(dt)
    return q, k, v


def out_proj(params: Params, o: torch.Tensor, x_dtype) -> torch.Tensor:
    """This rank's heads' share of the output projection (the whole of it
    on one device); ``tp.reduce(.., n_heads)`` sums the shares."""
    return torch.einsum("bshx,hxd->bsd", o, params["wo"].to(x_dtype))


def local_bias(b: torch.Tensor, n_heads: int) -> torch.Tensor:
    """A replicated per-head bias (..., n_heads, hd) cut to the heads this
    rank's head-sharded weights produce (its gradient, partial on each
    rank, summed over them)."""
    lo, hi = tp.local_range(n_heads)
    return tp.copy(b, n_heads)[..., lo:hi, :]


def local_kv(kv: torch.Tensor, cfg, dim: int = 2) -> torch.Tensor:
    """The KV heads (on ``dim``) this rank's query heads read, in the order
    the local grouping reads them (``tp.kv_heads_for_local_q``)."""
    sel = tp.kv_heads_for_local_q(cfg.n_heads, cfg.n_kv_heads, kv.shape[dim])
    if sel is None:
        return kv
    if isinstance(sel, slice):
        return kv.narrow(dim, sel.start, sel.stop - sel.start).contiguous()
    return kv.index_select(dim, sel.to(kv.device))


# ---------------------------------------------------------------------------
# core attention maths
# ---------------------------------------------------------------------------
def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,K,G,S,hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd).permute(0, 2, 3, 1, 4)


def _ungroup(o: torch.Tensor) -> torch.Tensor:
    """(B,K,G,S,hd) -> (B,S,H,hd)."""
    b, k, g, s, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, k * g, hd)


def naive_attention(q, k, v, *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Reference O(S^2)-memory attention.  q (B,S,H,hd), k/v (B,Skv,K,hd)."""
    qg = _group(q, k.shape[2])  # (B,K,G,Sq,hd)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bkgsh,btkh->bkgst", qg.float(), k.float()) * scale
    if causal:
        sq, skv = s.shape[-2], s.shape[-1]
        qi = q_offset + torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bkgsh", p.to(v.dtype), v)
    return _ungroup(o)


def blockwise_attention(q, k, v, *, causal: bool, chunk: int, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash-style, plain torch).

    q (B,Sq,H,hd), k/v (B,Skv,K,hd).  No (Sq, Skv) tensor is materialised
    beyond one (Sq, chunk) tile.
    """
    n_kv, skv = k.shape[2], k.shape[1]
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))

    qg = _group(q, n_kv).float()  # (B,K,G,Sq,hd)
    b, kk, g, sq, hd = qg.shape
    scale = hd ** -0.5
    kc = k.reshape(b, n_chunks, chunk, n_kv, hd).permute(1, 0, 3, 2, 4)  # (N,B,K,C,hd)
    vc = v.reshape(b, n_chunks, chunk, n_kv, hd).permute(1, 0, 3, 2, 4)
    qi = q_offset + torch.arange(sq, device=q.device)

    m = torch.full((b, kk, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kk, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kk, g, sq, hd), dtype=torch.float32, device=q.device)
    for idx in range(n_chunks):
        s = torch.einsum("bkgsh,bkch->bkgsc", qg, kc[idx].float()) * scale
        ki = idx * chunk + torch.arange(chunk, device=q.device)
        valid = ki < skv
        if causal:
            valid = valid[None, :] & (ki[None, :] <= qi[:, None])
        else:
            valid = valid[None, :].expand(sq, chunk)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgsc,bkch->bkgsh", p, vc[idx].float())
        m = m_new
    o = acc / torch.clamp_min(l[..., None], 1e-30)
    return _ungroup(o).to(q.dtype)


def pallas_attention(q, k, v, *, causal: bool, chunk: int, q_offset: int = 0) -> torch.Tensor:
    """The flash-attention kernel path through the dispatch API.

    ``cfg.attn_chunk`` becomes the KV block size.  The KV heads go to the op
    unexpanded: query head ``h`` reads KV head ``h // g``, the order of the
    reference's ``jnp.repeat``, which the kernel reads in place and the plain
    version expands.
    """
    from repro_torch.kernels import api

    return api.flash_attention(q, k, v, causal=causal, q_offset=q_offset, bk=chunk)


def attention_impl(cfg):
    if cfg.attn_impl == "naive":
        return partial(naive_attention)
    if cfg.attn_impl == "pallas":
        return partial(pallas_attention, chunk=cfg.attn_chunk)
    return partial(blockwise_attention, chunk=cfg.attn_chunk)


# ---------------------------------------------------------------------------
# full-sequence layer (train / prefill / encoder / cross)
# ---------------------------------------------------------------------------
def attention_block(
    params: Params,
    x: torch.Tensor,
    cfg,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    use_rope: bool = True,
    kv_x: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    seq: Optional[int] = None,
):
    """Full attention sub-layer (no residual/norm — caller owns those).

    ``kv_x`` switches to cross-attention (keys/values from encoder states).
    ``return_kv`` also returns the (k, v) a cache holds: this rank's KV heads
    where the ``model`` axis divides them, else all of them.  ``seq``: S's
    global size when ``x`` is this rank's S slice of a sequence-parallel
    stream (``tp.seq_len``; ``positions`` stay whole): S is gathered before
    the projections and the output reduce-scattered back to the slice.
    """
    dt = x.dtype
    s = seq
    kv_whole = not tp.sharded(cfg.n_kv_heads)  # read in part by the local query heads
    if kv_x is None and kv_whole:
        x = tp.gather_seq(x, s)
        xq, xkv = tp.copy(x, cfg.n_heads), x
    elif kv_x is None:
        xq = xkv = tp.copy_seq(x, cfg.n_heads, s)
    else:
        xq = tp.copy(x, cfg.n_heads)
        xkv = kv_x if kv_whole else tp.copy(kv_x, cfg.n_kv_heads)
    q = torch.einsum("bsd,dhx->bshx", xq, params["wq"].to(dt))
    k = torch.einsum("bsd,dkx->bskx", xkv, params["wk"].to(dt))
    v = torch.einsum("bsd,dkx->bskx", xkv, params["wv"].to(dt))
    if "bq" in params:
        q = q + local_bias(params["bq"], cfg.n_heads).to(dt)
        k = k + local_bias(params["bk"], cfg.n_kv_heads).to(dt)
        v = v + local_bias(params["bv"], cfg.n_kv_heads).to(dt)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        kpos = positions if kv_positions is None else kv_positions
        k = apply_rope(k, kpos, cfg.rope_theta)
    kv = (k, v)
    if kv_whole:
        k, v = tp.copy(k, cfg.n_heads), tp.copy(v, cfg.n_heads)
    o = attention_impl(cfg)(q, local_kv(k, cfg), local_kv(v, cfg), causal=causal)
    y = tp.reduce_seq(out_proj(params, o, dt), cfg.n_heads, s)
    return (y, kv) if return_kv else y


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, n_layers: int, dtype=torch.bfloat16,
               device="cuda"):
    """Stacked KV cache (L, B, Smax, K, hd) pair."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_specs(cfg, batch: int, max_len: int, n_layers: int, dtype=torch.bfloat16):
    """The cache's shapes and dtypes as tensors on the ``meta`` device
    (no storage): the counterpart of the reference's ShapeDtypeStructs."""
    return init_cache(cfg, batch, max_len, n_layers, dtype, device="meta")


def decode_attention(
    params: Params,
    x: torch.Tensor,
    cfg,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    *,
    use_rope: bool = True,
    update_cache: bool = True,
    write_plan: Optional[tuple] = None,
):
    """One decode step for one layer.

    x: (B, d) new-token hidden; cache_k/v: (B, Smax, K, hd); pos: (B,) int
    (index where the new token lands; a lane with pos >= Smax writes
    nothing).  Returns (y (B, d), new_k, new_v); the caches passed in are
    left as they were, unless a ``write_plan`` (:func:`dense_write_plan` of
    ``pos[:, None]``) writes the token into them in place.
    """
    b, _ = x.shape
    dt = x.dtype
    q = torch.einsum("bd,dhx->bhx", x, params["wq"].to(dt))
    k = torch.einsum("bd,dkx->bkx", x, params["wk"].to(dt))
    v = torch.einsum("bd,dkx->bkx", x, params["wv"].to(dt))
    if "bq" in params:
        q = q + local_bias(params["bq"], cfg.n_heads).to(dt)
        k = k + local_bias(params["bk"], cfg.n_kv_heads).to(dt)
        v = v + local_bias(params["bv"], cfg.n_kv_heads).to(dt)
    if use_rope:
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]

    smax = cache_k.shape[1]
    slots = torch.arange(smax, device=x.device)
    if update_cache and write_plan is not None:
        put_kv_(cache_k, write_plan, k[:, None])
        put_kv_(cache_v, write_plan, v[:, None])
    elif update_cache:
        write = (slots[None, :] == pos[:, None])[:, :, None, None]  # (B, Smax, 1, 1)
        cache_k = torch.where(write, k[:, None].to(cache_k.dtype), cache_k)
        cache_v = torch.where(write, v[:, None].to(cache_v.dtype), cache_v)

    h, hd = q.shape[1], cfg.head_dim
    ck, cv = local_kv(cache_k, cfg), local_kv(cache_v, cfg)
    k_heads = ck.shape[2]
    qg = q.reshape(b, k_heads, h // k_heads, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, ck.float()) * hd ** -0.5
    mask = slots[None] <= pos[:, None]  # (B, Smax)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bkgs,bskh->bkgh", p, cv.float())
    o = o / torch.clamp_min(p.sum(dim=-1)[..., None], 1e-30)
    o = o.reshape(b, h, hd).to(dt)
    y = torch.einsum("bhx,hxd->bd", o, params["wo"].to(dt))
    return tp.reduce(y, cfg.n_heads), cache_k, cache_v


# ---------------------------------------------------------------------------
# in-place KV writes
# ---------------------------------------------------------------------------
def kv_write_plan(slots: torch.Tensor, keep: torch.Tensor) -> tuple:
    """Index plan for writing E entries into a flat KV buffer in place,
    without reading ``keep`` back to the host: ``(slot, src, any_kept)``.

    slots, keep (E,): each entry's flat slot and whether it is written.  A
    dropped entry rewrites the first kept entry (its slot, its value); when
    none is kept every entry rewrites slot 0 with its own contents.  Kept
    entries must target distinct slots.  One plan serves every layer's k
    and v of a step (:func:`put_kv_`).
    """
    idx = torch.arange(keep.shape[0], device=keep.device)
    src = torch.where(keep, idx, keep.int().argmax())
    any_kept = keep.any()
    return torch.where(any_kept, slots[src], 0), src, any_kept


def dense_write_plan(smax: int, positions: torch.Tensor) -> tuple:
    """:func:`kv_write_plan` for the lane cache (B, Smax, K, hd): ``positions``
    (B, C); a position >= Smax is padding and writes nothing (the
    reference's one-hot select computes the same)."""
    positions = positions.long()
    lanes = torch.arange(positions.shape[0], device=positions.device)[:, None]
    return kv_write_plan((lanes * smax + positions).reshape(-1), (positions < smax).reshape(-1))


def put_kv_(cache: torch.Tensor, plan: tuple, val: torch.Tensor) -> torch.Tensor:
    """Write ``val`` (B, C, K, hd) into ``cache`` — the lane cache (B, Smax,
    K, hd) or the page pool (N_pages, page, K, hd) — in place, through a
    plan of :func:`dense_write_plan` or :func:`paged_write_plan`.  Returns
    ``cache``."""
    slot, src, any_kept = plan
    flat = cache.view(-1, *cache.shape[2:])
    v = val.reshape(-1, *val.shape[2:]).index_select(0, src).to(cache.dtype)
    flat.index_put_((slot,), torch.where(any_kept, v, flat[:1]))
    return cache


# ---------------------------------------------------------------------------
# paged KV cache: a global page pool indexed through per-lane block tables
# ---------------------------------------------------------------------------
# Layout: the dense (L, B, Smax, K, hd) per-lane cache becomes one global
# pool (L, N_pages, page, K, hd) shared by every lane.  A lane's cache is the
# ordered page list in its block-table row: logical position t lives in page
# ``bt[lane, t // page]`` at offset ``t % page``, so a gather of the row
# reconstructs the dense per-lane layout exactly (gathered index == logical
# position).  Lanes share read-only pages (common prefixes) by listing the
# same page id; the host-side allocator (repro_torch.serve.paging) guarantees
# a page referenced by more than one owner is never written.
def init_paged_cache(cfg, n_pages: int, page_size: int, n_layers: int,
                     dtype=torch.bfloat16, device="cuda"):
    """Global KV page pool (L, N_pages, page, K, hd) pair."""
    shape = (n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_cache_specs(cfg, n_pages: int, page_size: int, n_layers: int, dtype=torch.bfloat16):
    """The pool's shapes and dtypes on the ``meta`` device (no storage)."""
    return init_paged_cache(cfg, n_pages, page_size, n_layers, dtype, device="meta")


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Reconstruct the dense per-lane cache view from the page pool.

    pool (N_pages, page, K, hd); block_table (B, T) int page ids ->
    (B, T*page, K, hd) where gathered index t IS logical position t.
    Unallocated table slots (id 0 by convention) gather stale KV the
    attention masks drop (queries never look past their own position).
    """
    b, t = block_table.shape
    g = pool[block_table.long()]  # (B, T, page, K, hd)
    return g.reshape(b, t * pool.shape[1], *pool.shape[2:])


def paged_write_plan(page: int, block_table: torch.Tensor, positions: torch.Tensor) -> tuple:
    """:func:`kv_write_plan` for the page pool: ``block_table`` (B, T) maps
    ``positions`` (B, C) to pool slots (position t -> page ``bt[b, t //
    page]``, offset ``t % page``); a position >= T*page is padding and
    writes nothing.  Distinct (lane, entry) pairs target distinct slots: the
    allocator never maps two writers to one page, and a lane's positions are
    distinct by construction."""
    t = block_table.shape[1]
    positions = positions.long()
    pi = positions.div(page, rounding_mode="floor").clamp(0, t - 1)
    pages = torch.gather(block_table.long(), 1, pi)  # (B, C)
    return kv_write_plan((pages * page + positions % page).reshape(-1),
                      (positions < t * page).reshape(-1))


def paged_write(pool: torch.Tensor, block_table: torch.Tensor, positions: torch.Tensor,
                val: torch.Tensor) -> torch.Tensor:
    """Write new KV entries through the block table into a copy of the pool.

    pool (N_pages, page, K, hd); block_table (B, T); positions (B, C) logical
    slots (>= T*page is padding: no write); val (B, C, K, hd).  Returns the
    new pool; the one passed in is left as it was (the model's steps write
    in place through :func:`paged_write_plan` and :func:`put_kv_`).
    """
    plan = paged_write_plan(pool.shape[1], block_table, positions)
    return put_kv_(pool.clone(), plan, val)


def paged_decode_attention(
    params: Params,
    x: torch.Tensor,
    cfg,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    block_table: torch.Tensor,
    pos: torch.Tensor,
    write_plan: Optional[tuple] = None,
):
    """One decode step for one layer against the paged pool.

    Same contract as :func:`decode_attention` but the cache is the global
    (N_pages, page, K, hd) pool plus this batch's (B, T) block table; the new
    token's KV is written through the table, then the lane's pages are
    gathered back to the dense layout and attended exactly as the dense path.
    Lanes with ``pos >= T*page`` (empty/pad lanes) write nothing.  The pool
    is written in place (the reference returns a new one, which its jitted
    callers donate) through ``write_plan``, :func:`paged_write_plan` of
    ``pos[:, None]``, made here when not given.
    """
    b, _ = x.shape
    dt = x.dtype
    q = torch.einsum("bd,dhx->bhx", x, params["wq"].to(dt))
    k = torch.einsum("bd,dkx->bkx", x, params["wk"].to(dt))
    v = torch.einsum("bd,dkx->bkx", x, params["wv"].to(dt))
    if "bq" in params:
        q = q + local_bias(params["bq"], cfg.n_heads).to(dt)
        k = k + local_bias(params["bk"], cfg.n_kv_heads).to(dt)
        v = v + local_bias(params["bv"], cfg.n_kv_heads).to(dt)
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]

    if write_plan is None:
        write_plan = paged_write_plan(pool_k.shape[1], block_table, pos[:, None])
    put_kv_(pool_k, write_plan, k[:, None])
    put_kv_(pool_v, write_plan, v[:, None])
    ck = local_kv(gather_pages(pool_k, block_table), cfg)  # (B, T*page, K, hd)
    cv = local_kv(gather_pages(pool_v, block_table), cfg)

    h, hd = q.shape[1], cfg.head_dim
    k_heads = ck.shape[2]
    qg = q.reshape(b, k_heads, h // k_heads, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, ck.float()) * hd ** -0.5
    mask = torch.arange(ck.shape[1], device=x.device)[None] <= pos[:, None]  # (B, T*page)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bkgs,bskh->bkgh", p, cv.float())
    o = o / torch.clamp_min(p.sum(dim=-1)[..., None], 1e-30)
    o = o.reshape(b, h, hd).to(dt)
    y = torch.einsum("bhx,hxd->bd", o, params["wo"].to(dt))
    return tp.reduce(y, cfg.n_heads), pool_k, pool_v
