"""Grouped-query attention over the paged KV arena (counterpart of the
paged half of ``repro.models.attention``).

``attn_block`` scatters the step's K/V into the arena (in place — the
PyTorch port updates the arena tensors where JAX returns a new pytree)
and then attends either through the ragged paged-attention kernel
(``paged_attention=True``) or through the full-width gather +
``attend``, the reference route of the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels.ref import ragged_paged_attention_ref
from repro_torch.models.kvcache import quantize_kv
from repro_torch.models.layers import (apply_rotary, linear, rotary_cos_sin,
                                       softcap)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_positions: torch.Tensor, kv_positions: torch.Tensor,
           kv_valid_len: Optional[torch.Tensor] = None, causal: bool = True,
           window: Optional[int] = None,
           attn_softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,S,H,D]; k,v [B,T,KV,D]; positions are absolute token indices.
    Returns [B,S,H,D]. Masks use -1e30, as the JAX reference."""
    b, s, h, d = q.shape
    t = k.shape[1]
    n_kv = k.shape[2]
    qg = q.reshape(b, s, n_kv, h // n_kv, d)
    scale = torch.tensor(d ** -0.5, dtype=q.dtype, device=q.device)
    scores = torch.einsum("bskgd,btkd->bkgst", (qg * scale).float(),
                          k.float())
    scores = softcap(scores, attn_softcap)
    pq = q_positions[:, None, None, :, None]
    pk = kv_positions[:, None, None, None, :]
    mask = torch.ones((b, 1, 1, s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (pk <= pq)
    if window is not None:
        mask = mask & (pq - pk < window)
    if kv_valid_len is not None:
        valid = kv_positions < kv_valid_len[:, None]
        mask = mask & valid[:, None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, h, d)


def paged_cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor,
                      valid_len: Optional[torch.Tensor] = None) -> dict:
    """Scatter K/V tokens into one group's paged arena, in place.

    ``cache`` holds ``k_pages/v_pages [n_pages, page, kv_dim]`` plus
    ``block_tbl [B, max_pages]``; ``positions [B, S]`` are absolute write
    positions. Writes at or past ``valid_len`` (right padding, idle
    lanes) go to the null page 0, which no live table maps."""
    b, s, n_kv, hd = k.shape
    page = cache["k_pages"].shape[1]
    tbl = cache["block_tbl"]
    blk = torch.clamp(positions // page, 0, tbl.shape[1] - 1).long()
    page_idx = torch.gather(tbl, 1, blk).long()
    if valid_len is not None:
        page_idx = torch.where(positions < valid_len[:, None], page_idx,
                               torch.zeros_like(page_idx))
    off = (positions % page).long()
    if "k_scale_pages" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache["k_pages"][page_idx, off] = kq.reshape(b, s, n_kv * hd)
        cache["v_pages"][page_idx, off] = vq.reshape(b, s, n_kv * hd)
        cache["k_scale_pages"][page_idx, off] = ks
        cache["v_scale_pages"][page_idx, off] = vs
        return cache
    dt = cache["k_pages"].dtype
    cache["k_pages"][page_idx, off] = k.to(dt).reshape(b, s, n_kv * hd)
    cache["v_pages"][page_idx, off] = v.to(dt).reshape(b, s, n_kv * hd)
    return cache


def paged_cache_read(cache: dict, dtype, n_kv: int, hd: int):
    """Gather each sequence's pages into logical token order: k, v of
    shape ``[B, max_pages*page, n_kv, hd]`` (the FULL block-table width;
    entries past a sequence's valid length are garbage, masked by the
    caller)."""
    tbl = cache["block_tbl"].long()
    b, p = tbl.shape
    page = cache["k_pages"].shape[1]
    k = cache["k_pages"][tbl].reshape(b, p * page, n_kv, hd)
    v = cache["v_pages"][tbl].reshape(b, p * page, n_kv, hd)
    if "k_scale_pages" in cache:
        ks = cache["k_scale_pages"][tbl].reshape(b, p * page, n_kv)
        vs = cache["v_scale_pages"][tbl].reshape(b, p * page, n_kv)
        k = k.to(dtype) * ks[..., None].to(dtype)
        v = v.to(dtype) * vs[..., None].to(dtype)
    return k, v


def attn_block(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
               window: Optional[int], cache: dict,
               valid_len: Optional[torch.Tensor] = None,
               use_kernels: bool = True,
               paged_attention: bool = False) -> torch.Tensor:
    """Self-attention mixer over one group's paged arena (updated in
    place). ``valid_len`` [B] is each lane's absolute position bound."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = linear(x, p["wq"], p.get("bq"), use_kernels).reshape(b, s, nh, hd)
    k = linear(x, p["wk"], p.get("bk"), use_kernels).reshape(b, s, nkv, hd)
    v = linear(x, p["wv"], p.get("bv"), use_kernels).reshape(b, s, nkv, hd)
    cos, sin = rotary_cos_sin(positions, int(hd * cfg.rotary_pct) // 2 * 2,
                              cfg.rope_theta)
    q = apply_rotary(q, cos, sin, cfg.rotary_pct)
    k = apply_rotary(k, cos, sin, cfg.rotary_pct)

    paged_cache_write(cache, k, v, positions, valid_len=valid_len)
    valid = valid_len if valid_len is not None else positions[:, -1] + 1
    if paged_attention:
        if use_kernels:
            out = kpa.ragged_paged_attention(
                q, cache, positions[:, 0], valid, n_kv=nkv, head_dim=hd,
                window=window, attn_softcap=cfg.attn_softcap)
        else:
            out = ragged_paged_attention_ref(
                q, cache, positions[:, 0], valid, n_kv=nkv, head_dim=hd,
                window=window, attn_softcap=cfg.attn_softcap)[0].to(q.dtype)
    else:
        k_all, v_all = paged_cache_read(cache, x.dtype, nkv, hd)
        t_max = k_all.shape[1]
        kv_pos = torch.arange(t_max, device=x.device)[None, :].expand(b, -1)
        out = attend(q, k_all, v_all, q_positions=positions,
                     kv_positions=kv_pos, kv_valid_len=valid, causal=True,
                     window=window, attn_softcap=cfg.attn_softcap)
    return linear(out.reshape(b, s, nh * hd), p["wo"], p.get("bo"),
                  use_kernels)
