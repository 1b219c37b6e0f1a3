"""Top-level model API: ``init_params`` and the paged ``forward``
(counterpart of ``repro.models.model`` for decoder-only attention
stacks).

Parameters are nested dicts in the JAX layout: block leaves are stacked
over layer groups (``[G, ...]`` tensors, or per-group lists of
:class:`~repro_torch.core.qtensor.QTensor` after ``quantize_for_serving``),
and the forward pass loops over groups where JAX scans.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed_tokens, linear, rms_norm,
                                       softcap)


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype=torch.float32) -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the JAX package's layout and scales (not its values: the two
    frameworks draw different numbers from one seed)."""
    if cfg.is_encdec or cfg.n_vis_tokens:
        raise NotImplementedError("encoder-decoder and VLM models are not "
                                  "ported yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d = cfg.d_model
    params = {
        "embed": {"tok": B._normal(gen, (cfg.vocab, d), 0.02, dev, dtype)},
        "final_norm": torch.zeros((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = B._normal(gen, (d, cfg.vocab), d ** -0.5, dev,
                                      dtype)
    params["blocks"] = {
        f"b{i}": B.init_block(gen, kind, cfg.moe_slots[i], cfg,
                              cfg.n_groups, dev, dtype)
        for i, kind in enumerate(cfg.pattern)}
    return params


def group_slice(tree, g: int):
    """Group ``g``'s view of a group-stacked tree ([G, ...] tensors and
    per-group lists alike)."""
    if isinstance(tree, dict):
        return {k: group_slice(v, g) for k, v in tree.items()}
    return tree[g]


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            positions: torch.Tensor, cache: dict,
            valid_len: Optional[torch.Tensor] = None,
            use_kernels: bool = True,
            paged_attention: bool = False) -> torch.Tensor:
    """Logits ``[B, S, V]`` of one paged step; K/V of ``tokens`` are
    written into ``cache`` (the paged arena) in place.

    ``valid_len [B]`` bounds each lane's KV (writes at or past it land on
    the null page). ``use_kernels=False`` runs the plain version of every
    kernel (the counterpart of JAX's ``use_pallas=False``);
    ``paged_attention`` selects the ragged paged-attention route over the
    full-width gather."""
    x = embed_tokens(tokens, params["embed"]["tok"], cfg.scale_embed)
    for g in range(cfg.n_groups):
        for i, kind in enumerate(cfg.pattern):
            key = f"b{i}"
            x = B.apply_block(
                group_slice(params["blocks"][key], g), x, kind,
                cfg.moe_slots[i], cfg, positions=positions,
                cache=group_slice(cache[key], g), valid_len=valid_len,
                use_kernels=use_kernels, paged_attention=paged_attention)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"]["tok"].T.to(x.dtype))
    else:
        logits = linear(x, params["lm_head"], use_kernels=use_kernels)
    return softcap(logits, cfg.logit_softcap)
