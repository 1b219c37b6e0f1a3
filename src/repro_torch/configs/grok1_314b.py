"""Grok-1 314B — MoE, 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab=131072,
        attn_softcap=30.0, logit_softcap=30.0,
        n_experts=8, topk=2, moe_pattern=(True,),
    )
