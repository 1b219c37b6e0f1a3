"""DBRX-132B — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab=100352,
        rope_theta=500_000.0,
        n_experts=16, topk=4, moe_pattern=(True,),
    )
