"""Architecture config registry: 10 assigned archs + the paper's 4 SLMs.

A copy of ``repro.configs``, with the four shape suites of the dry run
(``configs/shapes.py``). `get_config(arch)` returns the full published
configuration; `reduced_config(arch)` returns a small same-family config
for CPU tests (few layers, narrow width, tiny vocab — structure preserved).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig
from repro_torch.configs import shapes  # noqa: F401 (re-exported)
from repro_torch.configs.shapes import (ShapeSuite, applicable_shapes,
                                        get_shape)

from repro_torch.configs.internvl2_2b import config as _internvl2
from repro_torch.configs.dbrx_132b import config as _dbrx
from repro_torch.configs.grok1_314b import config as _grok
from repro_torch.configs.stablelm_1_6b import config as _stablelm16
from repro_torch.configs.gemma2_2b import config as _gemma2
from repro_torch.configs.stablelm_3b import config as _stablelm3
from repro_torch.configs.granite_8b import config as _granite
from repro_torch.configs.whisper_medium import config as _whisper
from repro_torch.configs.mamba2_370m import config as _mamba2
from repro_torch.configs.jamba_1_5_large import config as _jamba
from repro_torch.configs.hymba_1_5b import config as _hymba
from repro_torch.configs.llama32_3b import config as _llama
from repro_torch.configs.phi_1_5b import config as _phi
from repro_torch.configs.qwen25_1_5b import config as _qwen

_REGISTRY = {
    # --- the 10 assigned architectures ---
    "internvl2-2b": _internvl2,
    "dbrx-132b": _dbrx,
    "grok-1-314b": _grok,
    "stablelm-1.6b": _stablelm16,
    "gemma2-2b": _gemma2,
    "stablelm-3b": _stablelm3,
    "granite-8b": _granite,
    "whisper-medium": _whisper,
    "mamba2-370m": _mamba2,
    "jamba-1.5-large-398b": _jamba,
    # --- the paper's own evaluation models ---
    "hymba-1.5b": _hymba,
    "llama-3.2-3b": _llama,
    "phi-1.5b": _phi,
    "qwen2.5-1.5b": _qwen,
}


ASSIGNED_ARCHS = ["internvl2-2b", "dbrx-132b", "grok-1-314b",
                  "stablelm-1.6b", "gemma2-2b", "stablelm-3b", "granite-8b",
                  "whisper-medium", "mamba2-370m", "jamba-1.5-large-398b"]
PAPER_ARCHS = ["hymba-1.5b", "llama-3.2-3b", "phi-1.5b", "qwen2.5-1.5b"]


def get_config(arch: str) -> ModelConfig:
    try:
        return _REGISTRY[arch]()
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_REGISTRY)}")


def reduced_config(arch: str) -> ModelConfig:
    """Shrink every dimension while preserving family structure."""
    cfg = get_config(arch)
    plen = len(cfg.pattern)
    n_layers = plen * 2                       # two groups
    heads = min(cfg.n_heads, 4) or 1
    kv = min(cfg.n_kv_heads, max(1, heads // 2)) or 1
    if cfg.n_heads and cfg.n_kv_heads:
        # preserve GQA divisibility
        while heads % kv:
            kv -= 1
    d_model = 128
    repl: Dict = dict(
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=heads if cfg.n_heads else 0,
        n_kv_heads=kv if cfg.n_kv_heads else 0,
        head_dim=(d_model // heads) if cfg.n_heads else 1,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        window=min(cfg.window, 16),
        n_experts=min(cfg.n_experts, 4),
        topk=min(cfg.topk, 2),
        d_state=16 if cfg.d_state else 0,
        ssm_headdim=32 if cfg.d_state else 64,
        n_enc_layers=2 if cfg.is_encdec else 0,
        enc_seq=16 if cfg.is_encdec else cfg.enc_seq,
        n_vis_tokens=8 if cfg.n_vis_tokens else 0,
    )
    return dataclasses.replace(cfg, **repl)


__all__ = ["ASSIGNED_ARCHS", "PAPER_ARCHS", "ShapeSuite",
           "applicable_shapes", "get_config", "get_shape", "reduced_config",
           "shapes"]
