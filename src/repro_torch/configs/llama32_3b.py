"""LLaMA-3.2-3B (paper model) [arXiv:2302.13971 lineage]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256,
        rope_theta=500_000.0, tie_embeddings=True,
    )
