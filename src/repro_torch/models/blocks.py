"""Block-level init/apply for the attention kinds with a dense FFN
(counterpart of ``repro.models.blocks``).

A block = pre-norm attention mixer + residual, then (if the config has an
FFN) pre-norm gated MLP + residual.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.attention import attn_block
from repro_torch.models.layers import glu_mlp, rms_norm


def _normal(gen, shape, std, device, dtype):
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * std).to(dtype)


def init_attn_params(gen, cfg, g: int, device, dtype=torch.float32) -> dict:
    """Attention weights for ``g`` groups, stacked [g, ...] (the JAX
    layout and scales)."""
    d = cfg.d_model

    def w(din, dout, std=None):
        return _normal(gen, (g, din, dout),
                       std if std is not None else 1.0 / math.sqrt(din),
                       device, dtype)

    p = {"wq": w(d, cfg.attn_dim), "wk": w(d, cfg.kv_dim),
         "wv": w(d, cfg.kv_dim),
         "wo": w(cfg.attn_dim, d,
                 1.0 / math.sqrt(cfg.attn_dim * 2 * cfg.n_layers))}
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.attn_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((g, n), dtype=dtype, device=device)
    return p


def init_mlp_params(gen, cfg, g: int, device, dtype=torch.float32) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w_up": _normal(gen, (g, d, ff), 1.0 / math.sqrt(d), device, dtype),
         "w_down": _normal(gen, (g, ff, d),
                           1.0 / math.sqrt(ff * 2 * cfg.n_layers), device,
                           dtype)}
    if cfg.gated_mlp:
        p["w_gate"] = _normal(gen, (g, d, ff), 1.0 / math.sqrt(d), device,
                              dtype)
    return p


def init_block(gen, kind: str, use_moe: bool, cfg, g: int, device,
               dtype=torch.float32) -> dict:
    if not kind.startswith("attn") or use_moe:
        raise NotImplementedError(
            f"block kind {kind!r} (moe={use_moe}) is not ported yet")
    p = {"norm1": torch.zeros((g, cfg.d_model), device=device),
         "attn": init_attn_params(gen, cfg, g, device, dtype)}
    if cfg.d_ff > 0:
        p["norm2"] = torch.zeros((g, cfg.d_model), device=device)
        p["ffn"] = init_mlp_params(gen, cfg, g, device, dtype)
    return p


def apply_block(p: dict, x: torch.Tensor, kind: str, use_moe: bool, cfg, *,
                positions: torch.Tensor, cache: dict,
                valid_len: Optional[torch.Tensor] = None,
                use_kernels: bool = True,
                paged_attention: bool = False) -> torch.Tensor:
    """One block over one group's paged cache (updated in place)."""
    if not kind.startswith("attn") or use_moe:
        raise NotImplementedError(
            f"block kind {kind!r} (moe={use_moe}) is not ported yet")
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    window = cfg.window if kind.endswith("_local") else None
    x = x + attn_block(p["attn"], h, cfg, positions=positions, window=window,
                       cache=cache["attn"], valid_len=valid_len,
                       use_kernels=use_kernels,
                       paged_attention=paged_attention)
    if "ffn" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + glu_mlp(h, p["ffn"], cfg.act, cfg.gated_mlp,
                        use_kernels=use_kernels)
    return x
