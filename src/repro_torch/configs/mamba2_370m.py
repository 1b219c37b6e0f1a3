"""Mamba2-370M — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, head_dim=1,
        d_ff=0, vocab=50280,
        pattern=("mamba",),
        d_state=128, ssm_headdim=64, expand=2,
        tie_embeddings=True,
    )
