"""The benchmark's frozen yardstick: peaks, FLOP and byte counts, and the
arithmetic that turns a device trace into busy time.

Nothing here reads the program: the counts are worked out from a
configuration file's sizes and the cell's shapes, so a change to the program
cannot move them.
"""
from __future__ import annotations

import math

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
#: (at the full 700 W power limit; a run records the card's own limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


# ---------------------------------------------------------------------------
# statistics over all of a window
# ---------------------------------------------------------------------------
def p95(values) -> float:
    """The 95th percentile (nearest rank) of ``values``; inf of none."""
    ordered = sorted(values)
    if not ordered:
        return math.inf
    rank = max(1, math.ceil(0.95 * len(ordered)))
    return ordered[rank - 1]


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no length has no rate")
    return count / seconds


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------
def busy_seconds(intervals) -> float:
    """The union of the device's [start, end) intervals, in their unit."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The [start, end) stretches of [lo, hi) in which no interval runs."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


# ---------------------------------------------------------------------------
# FLOPs and bytes (one configuration file's "model" block gives the sizes)
# ---------------------------------------------------------------------------
def attention_pairs(s: int, causal: bool = True) -> int:
    """Query-key pairs one head of one sequence of ``s`` positions scores."""
    return s * (s + 1) // 2 if causal else s * s


def flash_flops(b: int, s: int, h: int, hd: int, causal: bool = True) -> float:
    """QK^T and PV over the pairs attention needs: 2 matmuls, 2 FLOPs a
    multiply-add."""
    return 4.0 * b * h * hd * attention_pairs(s, causal)


def flash_bytes(b: int, s: int, h: int, kv: int, hd: int, itemsize: int = 2) -> float:
    """q, k and v read once, o written once."""
    return float(itemsize * b * s * hd * (2 * h + 2 * kv))


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def moe_lm_forward_flops(m: dict, tokens: int, seq: int) -> float:
    """Forward FLOPs of a MoE decoder over ``tokens`` tokens in sequences of
    ``seq`` (causal attention): 2 a weight a token over the active weights
    (attention projections, the router, ``experts_per_token`` experts, the
    output head; the embedding is a gather), and the attention's pairs."""
    d, h, kv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    proj = d * hd * (2 * h + 2 * kv)
    experts = m["experts_per_token"] * 3 * d * m["d_ff"]
    router = d * m["n_experts"]
    per_token = m["n_layers"] * (proj + experts + router) + d * m["vocab_size"]
    attn = m["n_layers"] * 4.0 * h * hd * attention_pairs(seq) * (tokens / seq)
    return 2.0 * tokens * per_token + attn


def moe_decode_flops(m: dict, context: int) -> float:
    """One decode token at ``context`` positions already cached."""
    d, h, kv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    proj = d * hd * (2 * h + 2 * kv)
    experts = m["experts_per_token"] * 3 * d * m["d_ff"]
    per_token = m["n_layers"] * (proj + experts + d * m["n_experts"]) + d * m["vocab_size"]
    return 2.0 * per_token + m["n_layers"] * 4.0 * h * hd * (context + 1)


def train_flops(m: dict, tokens: int, seq: int) -> float:
    """A training step: the forward and a backward of twice its FLOPs;
    remat's recomputed forward is not counted."""
    return 3.0 * moe_lm_forward_flops(m, tokens, seq)


def zamba2_forward_flops(m: dict, b: int, s: int) -> float:
    """Forward FLOPs of the hybrid over ``b`` sequences of ``s``: each
    Mamba2 layer's projections and its chunked SSD scan, each call of the
    shared attention block (projections from the concatenated 2d input, the
    causal pairs, its MLP) and the output head."""
    d, n, p = m["d_model"], m["ssm_state"], m["ssm_head_dim"]
    d_in = m["ssm_expand"] * d
    heads = d_in // p
    q = m["ssm_chunk"]
    tokens = b * s
    in_proj = d * (2 * d_in + 2 * n + heads)
    out_proj = d_in * d
    conv = (d_in + 2 * n) * m["ssm_conv_width"]
    # SSD: causal C.B scores (shared by the heads), their decayed product with
    # x, a chunk's state from B and x, and the state read back through C
    ssd = q * n + heads * (q * p + 4 * n * p)
    mamba = m["n_layers"] * (2.0 * (in_proj + out_proj + conv) + ssd) * tokens
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn_proj = 2 * d * hd * (h + 2 * kv) + h * hd * d
    mlp = (3 if m["mlp_variant"] in ("swiglu", "geglu") else 2) * d * m["d_ff"]
    calls = m["shared_attn_calls"]
    shared = calls * (2.0 * (attn_proj + mlp) * tokens
                      + 4.0 * h * hd * attention_pairs(s) * b)
    head = 2.0 * d * m["vocab_size"] * b  # the last position's logits
    return mamba + shared + head


# ---------------------------------------------------------------------------
# readings of a traced span
# ---------------------------------------------------------------------------
#: the flash-attention kernel's device functions (csrc/flash_attention.cu)
FLASH_KERNELS = ("tma_kernel", "simt_kernel", "wide_kernel")


def is_flash_kernel(name: str) -> bool:
    """Whether a device event is one of those functions (no other kernel
    of the program or of PyTorch carries these names)."""
    return any(k in name for k in FLASH_KERNELS)


def idle_share(trace: dict):
    """Percent of the traced span with no kernel running, or None."""
    if not trace or not trace.get("window_s") or not trace.get("device_events"):
        return None
    return 100.0 * max(0.0, 1.0 - trace["busy_s"] / trace["window_s"])
