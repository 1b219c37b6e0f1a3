"""Whisper-medium — encoder-decoder, conv frontend STUB [arXiv:2212.04356].

Assignment lists 24L: interpreted as 24 encoder + 24 decoder layers (the
published medium config). input_specs() provides 1500 precomputed frame
embeddings (the conv1d+mel frontend is a stub per the assignment).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51865,
        is_encdec=True, n_enc_layers=24, enc_seq=1500,
        act="gelu", gated_mlp=False, qkv_bias=True,
    )
