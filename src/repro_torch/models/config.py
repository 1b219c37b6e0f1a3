"""Unified model configuration covering all assigned architecture families.

A model is a stack of `n_groups` identical *groups*; each group applies the
block kinds in `pattern` in order (so gemma2's local/global alternation is
pattern=("attn_local", "attn") and jamba's 1:7 attn:mamba interleave is
pattern=("attn", "mamba" * 7)). The forward pass loops over groups.
A copy of ``repro.models.config``: the port imports nothing of ``repro``.

Block kinds
-----------
attn          global self-attention mixer (+ FFN if d_ff > 0)
attn_local    sliding-window self-attention mixer (+ FFN)
mamba         Mamba2 SSD mixer (+ FFN if d_ff > 0)
hybrid        parallel attn + SSM heads, outputs fused (Hymba-style)
hybrid_local  same with sliding-window attention
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # stacking
    pattern: Tuple[str, ...] = ("attn",)
    moe_pattern: Tuple[bool, ...] = (False,)   # per pattern slot: MoE FFN?

    # attention
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    window: int = 4096               # sliding window for *_local
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    scale_embed: bool = False        # gemma-style sqrt(d) embedding scale

    # MoE
    n_experts: int = 0
    topk: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2)
    d_state: int = 0
    ssm_headdim: int = 64
    expand: int = 2
    d_conv: int = 4
    ssm_ngroups: int = 1

    # encoder-decoder (whisper): n_layers counts DECODER layers
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500              # stub audio frontend sequence length

    # vlm stub frontend
    n_vis_tokens: int = 0

    # misc
    norm_eps: float = 1e-5
    act: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    qkv_bias: bool = False

    # quantized serving: "fp16" | "qtensor"
    serve_weights: str = "fp16"

    # ---- beyond-paper performance options (see EXPERIMENTS.md §Perf) ----
    chunked_ce: bool = False      # vocab-chunked fused lm_head + CE loss
    ce_chunk: int = 16384
    chunked_attn: bool = False    # KV-chunked online-softmax attention
    attn_chunk: int = 1024
    kv_cache_quant: bool = False  # int8 KV cache (decode bandwidth)
    remat_policy: str = "full"    # "full" | "dots" (save matmul outputs)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.n_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}")
        if len(self.moe_pattern) not in (1, len(self.pattern)):
            raise ValueError("moe_pattern must match pattern length (or 1)")

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def moe_slots(self) -> Tuple[bool, ...]:
        if len(self.moe_pattern) == 1:
            return self.moe_pattern * len(self.pattern)
        return self.moe_pattern

    @property
    def d_inner(self) -> int:        # mamba inner width
        return self.expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_ngroups * self.d_state

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def has_kind(self, kind_prefix: str) -> bool:
        return any(k.startswith(kind_prefix) for k in self.pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if no block performs *global* attention (long_500k rule)."""
        return not any(k in ("attn", "hybrid") for k in self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (used by memsys + roofline MODEL_FLOPS)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        n = v * d                                   # embedding
        if not self.tie_embeddings:
            n += d * v                              # lm head
        per_kind = {}
        attn_p = d * self.attn_dim + 2 * d * self.kv_dim \
            + self.attn_dim * d + d
        mlp_p = ((3 if self.gated_mlp else 2) * d * ff + d) if ff else 0
        moe_p = (d * self.n_experts
                 + self.n_experts * (3 if self.gated_mlp else 2) * d * ff
                 + d) if self.n_experts else 0
        ssm_p = (d * (2 * self.d_inner + 2 * self.ssm_ngroups * self.d_state
                      + self.ssm_nheads)
                 + self.conv_dim * self.d_conv
                 + 3 * self.ssm_nheads + self.d_inner
                 + self.d_inner * d + d)
        for slot, kind in enumerate(self.pattern):
            p = 0
            if kind.startswith("attn"):
                p += attn_p
            elif kind == "mamba":
                p += ssm_p
            elif kind.startswith("hybrid"):
                p += attn_p + ssm_p
            if kind != "mamba" or ff:
                p += moe_p if self.moe_slots[slot] else mlp_p
            per_kind[slot] = p
        n += self.n_groups * sum(per_kind.values())
        if self.is_encdec:
            enc_p = attn_p + mlp_p
            cross_p = attn_p
            n += self.n_enc_layers * enc_p + self.n_layers * cross_p
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_expert = (3 if self.gated_mlp else 2) * d * ff
        n_moe_slots = sum(1 for s in self.moe_slots if s) * self.n_groups
        inactive = n_moe_slots * (self.n_experts - self.topk) * dense_expert
        return self.param_count() - inactive
