"""StableLM-3B — dense, MHA (kv=32) [hf:stabilityai/stablelm-2-1_6b family]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab=50304,
        rotary_pct=0.25, qkv_bias=True,
    )
