"""Config dataclasses: architectures and input-shape suites.

Every assigned architecture is a ``ModelConfig``; every assigned input shape
is a ``ShapeConfig``.  ``(arch, shape)`` pairs form the dry-run/roofline cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (superset across the 10 assigned archs)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    # --- MLP / attention details ---
    mlp_variant: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- SSM / hybrid (mamba2, zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_every_k_macro: int = 0  # zamba2: shared attn block every k macro-blocks
    macro_size: int = 1  # layers per macro block (scan unit)

    # --- xLSTM ---
    xlstm_slstm_per_macro: int = 0  # sLSTM layers appended per macro block
    xlstm_mlstm_per_macro: int = 0

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # --- modality frontend stubs ---
    frontend: Optional[str] = None  # "audio" | "vision"
    frontend_len: int = 0  # precomputed embeddings prepended / cross-attended

    # --- numerics / execution ---
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"
    attn_chunk: int = 1024  # blockwise-attention KV chunk
    attn_impl: str = "blockwise"  # blockwise | naive | pallas
    # xla (chunked-scan in jnp) | pallas (kernels.api ssm_scan; stateful
    # calls — decode prefill with h0 / return_state — stay on the jnp scan)
    ssm_impl: str = "xla"
    remat: bool = True  # checkpoint each layer block in training
    remat_policy: str = "full"  # full (recompute all) | dots (save matmul outputs)
    zero_stage: int = 3  # 0: none, 1: opt state, 2: +grads, 3: +fp32 params (FSDP)
    scan_layers: bool = True

    train_microbatches: int = 1  # gradient-accumulation splits of the global batch

    # --- distribution knobs (overridable per experiment) ---
    moe_shard: str = "expert"  # expert (EP on model axis) | ffn (TP inside expert)
    serve_param_fsdp: bool = False  # serving weights also sharded over data
    shard_kv_seq_decode: bool = False  # flash-decoding style KV-seq sharding
    logits_parallel: bool = True  # keep logits vocab-sharded through the loss

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 128 (TP-divisible, lane-aligned). Pad logits
        are masked to -inf; targets never index the pad region."""
        return -(-self.vocab_size // 128) * 128

    @property
    def is_subquadratic(self) -> bool:
        """Whether the arch can run the long_500k cell (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def max_useful_tp(self, limit: int = 1 << 30) -> int:
        """Largest tensor-parallel degree (<= ``limit``) that actually
        shards attention: it must divide both ``n_heads`` (wq/wo) and
        ``n_kv_heads`` (wk/wv and the KV cache).  Beyond this the
        divisibility-guarded sharding rules leave those weights replicated,
        so extra devices add communication without splitting the work —
        ``ClusterConfig.tp`` should not exceed it (see docs/scaling.md)."""
        tp = 1
        for d in range(1, min(self.n_heads, limit) + 1):
            if self.n_heads % d == 0 and self.n_kv_heads % d == 0:
                tp = d
        return tp

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper is enc-dec, not enc-only)

    def supports_shape(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k":
            return self.is_subquadratic
        return True

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline checks)."""
        d, hd = self.d_model, self.head_dim
        qkvo = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.qkv_bias:
            qkvo += (self.n_heads + 2 * self.n_kv_heads) * hd
        if self.mlp_variant in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        norms = 2 * d  # per layer

        if self.family == "moe":
            moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            per_layer = qkvo + moe + norms
            return self.n_layers * per_layer + emb + head + d
        if self.family == "ssm":  # xlstm
            return self.n_layers * self._xlstm_block_params() + emb + head + d
        if self.family == "hybrid":  # zamba2
            mamba = self.n_layers * self._mamba_block_params()
            shared_attn = qkvo * 4 + mlp  # shared block takes concat(2d) input
            return mamba + shared_attn + emb + head + d
        if self.family == "encdec":
            enc = self.n_enc_layers * (qkvo + mlp + 2 * norms)
            dec = self.n_dec_layers * (2 * qkvo + mlp + 3 * norms)
            return enc + dec + emb + head + 2 * d
        # dense / vlm backbone
        per_layer = qkvo + mlp + norms
        return self.n_layers * per_layer + emb + head + d

    def _mamba_block_params(self) -> int:
        d = self.d_model
        d_in = self.ssm_expand * d
        nheads = d_in // self.ssm_head_dim
        in_proj = d * (2 * d_in + 2 * self.ssm_state + nheads)
        conv = (d_in + 2 * self.ssm_state) * self.ssm_conv_width
        out_proj = d_in * d
        return in_proj + conv + out_proj + 2 * nheads + d

    def _xlstm_block_params(self) -> int:
        d = self.d_model
        hd = d // self.n_heads
        # mLSTM block: qkv + gates + out + ln
        qkv = 3 * d * d
        gates = 2 * d * self.n_heads  # i,f per head
        up = 2 * d * 2 * d  # up-projection pair (gated)
        down = 2 * d * d
        return qkv + gates + up + down + 2 * d

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.head_dim
        qkvo = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        act_moe = self.experts_per_token * 3 * d * self.d_ff + d * self.n_experts
        per_layer = qkvo + act_moe + 2 * d
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return self.n_layers * per_layer + emb + head + d

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            attn_chunk=32,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=16,
            frontend_len=8 if self.frontend_len else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_dec_layers=min(self.n_dec_layers, 2),
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            macro_size=min(self.macro_size, 2),
            xlstm_mlstm_per_macro=min(self.xlstm_mlstm_per_macro, 1),
            xlstm_slstm_per_macro=min(self.xlstm_slstm_per_macro, 1),
            attn_every_k_macro=min(self.attn_every_k_macro, 2),
            dtype="float32",
            param_dtype="float32",
            remat=False,
        )
        if self.family == "ssm":
            kw["n_layers"] = 4
        elif self.family == "hybrid":
            kw["n_layers"] = 5  # 1 super-unit (4 layers) + 1 tail layer
        return dataclasses.replace(self, **kw)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
