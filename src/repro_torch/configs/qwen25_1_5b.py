"""Qwen2.5-1.5B-Instruct (paper model) [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936,
        rope_theta=1_000_000.0, qkv_bias=True, tie_embeddings=True,
    )
