"""KV / SSM cache construction for every block kind, stacked over layer
groups, and the int8 KV quantizer (counterpart of
``repro.models.kvcache``).

Two attention-cache layouts share one quantization scheme:

  * contiguous ``[B, T, kv_dim]`` — one slab per sequence, used by
    ``prefill`` / ``decode_step`` and the legacy per-slot engine
    (``init_cache``; ``init_encdec_cache`` adds the decoder's
    cross-attention K/V, ``{"self", "cross": {"xk", "xv"}}`` per decoder
    layer);
  * paged ``[n_pages, page, kv_dim]`` — a shared arena addressed through
    per-sequence block tables; page 0 is the null page that inactive
    lanes and right padding write into and no live table maps.

The SSM and conv state of mamba and hybrid blocks stays dense per slot
beside either (it is O(1) in sequence length): ``ssm [G, slots, H, P,
N]`` in fp32 and ``conv [G, slots, K-1, conv_dim]`` in the cache dtype.
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


def _attn_cache(cfg, batch: int, max_len: int, dtype, device,
                n_groups: int) -> dict:
    """One block's contiguous K/V ``[G, B, T, kv_dim]`` (int8 with bf16
    per-(token, head) scales under ``kv_cache_quant``)."""
    kvd = cfg.n_kv_heads * cfg.head_dim
    g = n_groups

    def z(shape, dt):
        return torch.zeros((g,) + shape, dtype=dt, device=device)

    if cfg.kv_cache_quant:
        return {"k": z((batch, max_len, kvd), torch.int8),
                "v": z((batch, max_len, kvd), torch.int8),
                "k_scale": z((batch, max_len, cfg.n_kv_heads),
                             torch.bfloat16),
                "v_scale": z((batch, max_len, cfg.n_kv_heads),
                             torch.bfloat16)}
    return {"k": z((batch, max_len, kvd), dtype),
            "v": z((batch, max_len, kvd), dtype)}


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


def _mamba_cache(cfg, batch: int, dtype, device, n_groups: int) -> dict:
    """One block's dense per-slot SSM (always fp32) and conv state,
    stacked over groups."""
    g = n_groups
    return {"ssm": torch.zeros((g, batch, cfg.ssm_nheads, cfg.ssm_headdim,
                                cfg.d_state), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((g, batch, cfg.d_conv - 1, cfg.conv_dim),
                                dtype=dtype, device=device)}


def paged_block_cache(cfg, kind: str, n_pages: int, page: int,
                      max_slots: int, max_pages_per_seq: int, dtype,
                      device, n_groups: int) -> dict:
    """One block's cache by kind: attention K/V in the paged arena, SSM /
    conv state dense per slot."""
    c = {}
    if kind.startswith(("attn", "hybrid")):
        c["attn"] = paged_attn_cache(cfg, n_pages, page, max_slots,
                                     max_pages_per_seq, dtype, device,
                                     n_groups)
    if kind == "mamba" or kind.startswith("hybrid"):
        c["mamba"] = _mamba_cache(cfg, max_slots, dtype, device, n_groups)
    if not c:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    return c


def paged_init_cache(cfg, n_pages: int, page: int, max_slots: int,
                     max_pages_per_seq: int, dtype=torch.bfloat16,
                     device="cuda") -> dict:
    """Paged pool: ``{"b<i>": {"attn": {...}, "mamba": {"ssm", "conv"}}}``
    (the parts each block kind has), leaves with a leading n_groups dim
    (the JAX layout). ``n_pages`` includes the null page. Unquantized
    pages default to bf16, as the reference's do; the engines name their
    dtype (fp32 by default)."""
    return {f"b{i}": paged_block_cache(cfg, kind, n_pages, page, max_slots,
                                       max_pages_per_seq, dtype, device,
                                       cfg.n_groups)
            for i, kind in enumerate(cfg.pattern)}


def block_cache(cfg, kind: str, batch: int, max_len: int, dtype, device,
                n_groups: int) -> dict:
    """One block's contiguous cache by kind: K/V slabs and/or the dense
    SSM and conv state."""
    c = {}
    if kind.startswith(("attn", "hybrid")):
        c["attn"] = _attn_cache(cfg, batch, max_len, dtype, device,
                                n_groups)
    if kind == "mamba" or kind.startswith("hybrid"):
        c["mamba"] = _mamba_cache(cfg, batch, dtype, device, n_groups)
    return c


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """Contiguous cache ``{"b<i>": {"attn": {...}, "mamba": {...}}}``,
    leaves with a leading n_groups dim (the JAX layout)."""
    return {f"b{i}": block_cache(cfg, kind, batch, max_len, dtype, device,
                                 cfg.n_groups)
            for i, kind in enumerate(cfg.pattern)}


def init_encdec_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cuda") -> dict:
    """Decoder cache: self-attention K/V plus the cross-attention K/V
    ``[L, B, enc_seq, KV, hd]`` (filled at prefill), over the L decoder
    layers."""
    ll = cfg.n_layers
    shape = (ll, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"self": _attn_cache(cfg, batch, max_len, dtype, device, ll),
            "cross": {"xk": torch.zeros(shape, dtype=dtype, device=device),
                      "xv": torch.zeros(shape, dtype=dtype,
                                        device=device)}}


def cache_bytes(cache) -> int:
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    return cache.numel() * cache.element_size()
