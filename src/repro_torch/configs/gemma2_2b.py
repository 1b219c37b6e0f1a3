"""Gemma2-2B — local/global alternating attention, logit softcap

[arXiv:2408.00118]. Pattern = (sliding-window local, global) per group.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        d_ff=9216, vocab=256000, head_dim=256,
        pattern=("attn_local", "attn"), window=4096,
        attn_softcap=50.0, logit_softcap=30.0,
        scale_embed=True, tie_embeddings=True,
        act="gelu",
    )
