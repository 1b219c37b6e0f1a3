"""Hymba-1.5B (paper model) — parallel attention+SSM hybrid heads

[arXiv:2411.13676]. Parallel-head fusion approximated as mean of the two
mixer outputs; mostly sliding-window with periodic global layers.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001,
        pattern=("hybrid", "hybrid_local", "hybrid_local", "hybrid_local"),
        window=1024,
        d_state=128, ssm_headdim=64, expand=2,
    )
