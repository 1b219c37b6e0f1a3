"""Jamba-1.5-Large (398B) — Mamba+attention 1:7 interleave, MoE 16e top-2

[arXiv:2403.19887]. Groups of 8 layers: 1 attention + 7 mamba; MoE FFN on
every other layer in the group.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab=65536,
        pattern=("attn",) + ("mamba",) * 7,
        moe_pattern=(False, True, False, True, False, True, False, True),
        n_experts=16, topk=2,
        d_state=128, ssm_headdim=128, expand=2,
    )
