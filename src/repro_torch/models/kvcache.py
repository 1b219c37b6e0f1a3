"""Paged KV arena construction and the int8 KV quantizer (counterpart of
the paged half of ``repro.models.kvcache``).

The arena is ``[n_pages, page, kv_dim]`` per layer group, addressed
through per-sequence block tables; page 0 is the null page that inactive
lanes and right padding write into and no live table maps.
"""
from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8: x [..., n_kv, hd] -> (codes int8
    [..., n_kv, hd], scale bf16 [..., n_kv]). The codes come from the fp32
    scale (+1e-8); only then is the scale stored as bf16."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0 + 1e-8
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale.to(torch.bfloat16)


def paged_attn_cache(cfg, n_pages: int, page: int, max_slots: int,
                     max_pages_per_seq: int, dtype, device,
                     n_groups: int) -> dict:
    """One block's paged K/V arena + block table, stacked over groups."""
    kvd = cfg.n_kv_heads * cfg.head_dim
    g = n_groups

    def z(shape, dt):
        return torch.zeros((g,) + shape, dtype=dt, device=device)

    c = {"block_tbl": z((max_slots, max_pages_per_seq), torch.int32)}
    if cfg.kv_cache_quant:
        c.update({"k_pages": z((n_pages, page, kvd), torch.int8),
                  "v_pages": z((n_pages, page, kvd), torch.int8),
                  "k_scale_pages": z((n_pages, page, cfg.n_kv_heads),
                                     torch.bfloat16),
                  "v_scale_pages": z((n_pages, page, cfg.n_kv_heads),
                                     torch.bfloat16)})
    else:
        c.update({"k_pages": z((n_pages, page, kvd), dtype),
                  "v_pages": z((n_pages, page, kvd), dtype)})
    return c


def paged_init_cache(cfg, n_pages: int, page: int, max_slots: int,
                     max_pages_per_seq: int, dtype=torch.float32,
                     device="cpu") -> dict:
    """Paged pool: ``{"b<i>": {"attn": {...}}}``, leaves with a leading
    n_groups dim (the JAX layout). ``n_pages`` includes the null page."""
    out = {}
    for i, kind in enumerate(cfg.pattern):
        if not kind.startswith("attn"):
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet (attention only)")
        out[f"b{i}"] = {"attn": paged_attn_cache(
            cfg, n_pages, page, max_slots, max_pages_per_seq, dtype,
            device, cfg.n_groups)}
    return out
