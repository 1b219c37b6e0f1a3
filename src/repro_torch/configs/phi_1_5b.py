"""Phi-1.5 (paper model) [Microsoft]. Partial rotary, gelu MLP."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-1.5b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=51200,
        rotary_pct=0.5, act="gelu", gated_mlp=False, qkv_bias=True,
    )
