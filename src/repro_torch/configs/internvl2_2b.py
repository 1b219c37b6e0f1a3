"""InternVL2-2B — InternViT frontend (stub) + InternLM2-1.8B backbone.

[arXiv:2404.16821; hf]. The vision tower is a STUB per the assignment:
input_specs() provides 256 precomputed patch embeddings at d_model.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", family="vlm",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab=92553,
        rope_theta=1_000_000.0,
        n_vis_tokens=256,
    )
