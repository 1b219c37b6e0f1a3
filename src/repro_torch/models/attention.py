"""Grouped-query attention, cache-less, over the paged KV arena or over a
contiguous cache, and the encoder-decoder cross-attention (counterpart of
``repro.models.attention``).

Without a cache ``attn_block`` attends over the step's own K/V (the
forward the PTQ path evaluates with), through ``attend`` or, for long
inputs under ``cfg.chunked_attn``, the online-softmax ``attend_chunked``.
With the paged arena it scatters the step's K/V into it (in place — the
PyTorch port updates the arena tensors where JAX returns a new pytree)
and then attends either through the ragged paged-attention kernel
(``paged_attention=True``) or through the full-width gather +
``attend``, the reference route of the JAX package. With a contiguous
cache (``prefill`` / ``decode_step``) it writes the step's K/V at the
reference's position (0 for a multi-token call, ``pos`` for one token),
in place, and attends over the whole slab through ``attend``, as the
reference does (no kernel there).

Under a mesh (``runtime_context.use_mesh``) the block runs the rank's
``n_kv / M`` KV heads and their query heads: ``wq``/``wk``/``wv`` are
column-parallel and ``wo`` row-parallel (``layers.column_linear``,
``row_linear``), the encoder's and the cross-attention's too. Where the
heads or the KV heads do not divide ``M`` (hymba-1.5b's 25 and 5) the
block's weights are whole on every model rank and every rank runs every
head, ``wo`` whole and no sum after it (``layers.attn_replicated``); the
arena then holds every KV head. With a page slice (a mesh whose data
axis is over 1) the arena holds the rank's slice of the pages: the step's K/V rows land
only in pages of the slice, at ``global - first`` (other rows in the
slice's sink page), the kernel reads the slice's pages, and the slices'
``(o, m, l)`` merge over the data group (``kernels.paged_attention.
merge_over``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import runtime_context as ctx
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels.ref import ragged_paged_attention_ref
from repro_torch.models.kvcache import quantize_kv
from repro_torch.models.layers import (apply_rotary, attn_replicated,
                                       column_linear, linear,
                                       rotary_cos_sin, row_linear, softcap,
                                       tp_input, tp_size)


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
    # a fill on the device, not a copy from the host: a CUDA graph of the
    # step can capture it
    scale = torch.full((), d ** -0.5, dtype=q.dtype, device=q.device)
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


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor,
                   causal: bool = True, window: Optional[int] = None,
                   attn_softcap: Optional[float] = None,
                   chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``chunk`` tokens: scores
    exist only at [S, chunk] at a time. A Python loop takes the place of
    the reference's ``lax.scan``; padding keys sit at position 2^30."""
    b, s, h, d = q.shape
    t = k.shape[1]
    n_kv = k.shape[2]
    if t % chunk:
        pad = chunk - t % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=2 ** 30)
        t += pad
    g = h // n_kv
    scale = torch.full((), d ** -0.5, dtype=q.dtype, device=q.device)
    qg = (q.reshape(b, s, n_kv, g, d) * scale).float()
    pq = q_positions[:, None, None, :, None]             # [B,1,1,S,1]
    m = torch.full((b, n_kv, g, s), -1e30, device=q.device)
    l = torch.zeros((b, n_kv, g, s), device=q.device)
    acc = torch.zeros((b, n_kv, g, s, d), device=q.device)
    for c0 in range(0, t, chunk):
        k_c, v_c = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        pk = kv_positions[:, c0:c0 + chunk][:, None, None, None, :]
        scores = softcap(torch.einsum("bskgd,btkd->bkgst", qg, k_c.float()),
                         attn_softcap)
        mask = pk < 2 ** 30
        if causal:
            mask = mask & (pk <= pq)
        if window is not None:
            mask = mask & (pq - pk < window)
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(v_c.dtype), v_c).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]     # [B,KV,G,S,D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def paged_cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor,
                      valid_len: Optional[torch.Tensor] = None,
                      page_slice=None) -> dict:
    """Scatter K/V tokens into one group's paged arena, in place.

    ``cache`` holds ``k_pages/v_pages [n_pages, page, kv_dim]`` plus
    ``block_tbl [B, max_pages]``; ``positions [B, S]`` are absolute write
    positions. Writes at or past ``valid_len`` (right padding, idle
    lanes) go to the null page 0, which no live table maps. With a
    ``page_slice`` ``(first, n)`` the pages are global pages ``[first,
    first + n)`` plus the sink page ``n``: a row lands at ``global -
    first`` when its page is in the slice, else in the sink (so padding
    rows reach the null page on the rank that holds page 0)."""
    b, s, n_kv, hd = k.shape
    page = cache["k_pages"].shape[1]
    tbl = cache["block_tbl"]
    blk = torch.clamp(positions // page, 0, tbl.shape[1] - 1).long()
    page_idx = torch.gather(tbl, 1, blk).long()
    if valid_len is not None:
        page_idx = torch.where(positions < valid_len[:, None], page_idx,
                               torch.zeros_like(page_idx))
    if page_slice is not None:
        first, n = page_slice
        local = page_idx - first
        page_idx = torch.where((local >= 0) & (local < n), local,
                               torch.full_like(local, n))
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


def _cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                 pos0) -> dict:
    """Write K/V of ``s`` tokens at ``pos0`` (an int or a 0-dim tensor)
    into one group's contiguous cache ``[B, T, KV*hd]``, in place; int8
    caches take ``quantize_kv``'s codes and scales. As the reference's
    ``dynamic_update_slice``, a start past ``T - s`` is clamped to it."""
    b, s, n_kv, hd = k.shape
    start = torch.as_tensor(pos0, dtype=torch.int64, device=k.device)
    idx = torch.arange(s, device=k.device) + torch.clamp(
        start, 0, cache["k"].shape[1] - s)
    if "k_scale" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        writes = {"k": kq.reshape(b, s, n_kv * hd),
                  "v": vq.reshape(b, s, n_kv * hd),
                  "k_scale": ks, "v_scale": vs}
    else:
        dt = cache["k"].dtype
        writes = {"k": k.to(dt).reshape(b, s, n_kv * hd),
                  "v": v.to(dt).reshape(b, s, n_kv * hd)}
    for name, val in writes.items():
        cache[name].index_copy_(1, idx, val)
    return cache


def _cache_read(cache: dict, dtype, n_kv: int, hd: int):
    """K, V ``[B, T, n_kv, hd]`` of a contiguous cache (int8 codes times
    their scales, in ``dtype``)."""
    b, t, _ = cache["k"].shape
    k = cache["k"].reshape(b, t, n_kv, hd)
    v = cache["v"].reshape(b, t, n_kv, hd)
    if "k_scale" in cache:
        k = k.to(dtype) * cache["k_scale"][..., None].to(dtype)
        v = v.to(dtype) * cache["v_scale"][..., None].to(dtype)
    return k, v


def attn_block(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
               window: Optional[int], cache: Optional[dict] = None,
               pos=None, valid_len: Optional[torch.Tensor] = None,
               use_kernels: bool = True,
               paged_attention: bool = False, tap=None) -> torch.Tensor:
    """Self-attention mixer, cache-less (``cache=None``), over one group's
    paged arena or over its contiguous cache (both updated in place).
    ``valid_len`` [B] is each lane's absolute position bound; ``pos`` the
    contiguous write position of a one-token call (default
    ``positions[0, 0]``). ``tap(name, value)`` records the inputs of
    ``wq`` (shared by ``wk`` and ``wv``) and ``wo`` for calibration."""
    b, s, _ = x.shape
    hd, nh, nkv = (cfg.head_dim,) + rank_heads(cfg)
    if tap:
        tap("wq", x)
    x = head_input(x, cfg)
    q = head_proj(x, p["wq"], p.get("bq"), cfg, use_kernels,
                  cfg.n_heads).reshape(b, s, nh, hd)
    k = head_proj(x, p["wk"], p.get("bk"), cfg, use_kernels,
                  cfg.n_kv_heads).reshape(b, s, nkv, hd)
    v = head_proj(x, p["wv"], p.get("bv"), cfg, use_kernels,
                  cfg.n_kv_heads).reshape(b, s, nkv, hd)
    cos, sin = rotary_cos_sin(positions, int(hd * cfg.rotary_pct) // 2 * 2,
                              cfg.rope_theta)
    q = apply_rotary(q, cos, sin, cfg.rotary_pct)
    k = apply_rotary(k, cos, sin, cfg.rotary_pct)

    if cache is None:
        kw = dict(q_positions=positions, kv_positions=positions, causal=True,
                  window=window, attn_softcap=cfg.attn_softcap)
        if cfg.chunked_attn and s > cfg.attn_chunk:
            out = attend_chunked(q, k, v, chunk=cfg.attn_chunk, **kw)
        else:
            out = attend(q, k, v, **kw)
        return out_proj(p, out, tap, use_kernels, cfg)
    valid = valid_len if valid_len is not None else positions[:, -1] + 1
    if "k_pages" not in cache:                       # contiguous cache
        pos0 = 0 if s > 1 else (pos if pos is not None else positions[0, 0])
        _cache_write(cache, k, v, pos0)
        k_all, v_all = _cache_read(cache, x.dtype, nkv, hd)
        t_max = k_all.shape[1]
        kv_pos = torch.arange(t_max, device=x.device)[None, :].expand(b, -1)
        out = attend(q, k_all, v_all, q_positions=positions,
                     kv_positions=kv_pos, kv_valid_len=valid, causal=True,
                     window=window, attn_softcap=cfg.attn_softcap)
        return out_proj(p, out, tap, use_kernels, cfg)
    page_slice = ctx.current_page_slice()
    paged_cache_write(cache, k, v, positions, valid_len=valid_len,
                      page_slice=page_slice)
    kw = dict(n_kv=nkv, head_dim=hd, window=window,
              attn_softcap=cfg.attn_softcap)
    if page_slice is not None:
        if not paged_attention:
            raise NotImplementedError(
                "a sliced arena is read through the ragged kernel "
                "(paged_attention=True); the full-width gather needs "
                "every page")
        call = (kpa.ragged_paged_attention_call if use_kernels
                else ragged_paged_attention_ref)
        o, m, l = call(q, cache, positions[:, 0], valid,
                       page_slice=page_slice, **kw)
        out = kpa.merge_over(o, m, l, ctx.current_mesh()).to(q.dtype)
    elif paged_attention:
        if use_kernels:
            out = kpa.ragged_paged_attention(q, cache, positions[:, 0],
                                             valid, **kw)
        else:
            out = ragged_paged_attention_ref(
                q, cache, positions[:, 0], valid, **kw)[0].to(q.dtype)
    else:
        k_all, v_all = paged_cache_read(cache, x.dtype, nkv, hd)
        t_max = k_all.shape[1]
        kv_pos = torch.arange(t_max, device=x.device)[None, :].expand(b, -1)
        out = attend(q, k_all, v_all, q_positions=positions,
                     kv_positions=kv_pos, kv_valid_len=valid, causal=True,
                     window=window, attn_softcap=cfg.attn_softcap)
    return out_proj(p, out, tap, use_kernels, cfg)


def rank_heads(cfg):
    """``(query heads, KV heads)`` an attention block runs on this rank:
    its ``1 / M`` of each under TP, all of them off a mesh or where they
    do not divide ``M`` (``layers.attn_replicated``)."""
    tp = tp_size()
    if tp == 1 or attn_replicated(cfg, tp):
        return cfg.n_heads, cfg.n_kv_heads
    return cfg.n_heads // tp, cfg.n_kv_heads // tp


def _split_heads(cfg) -> bool:
    """Whether this rank runs a slice of the heads (TP)."""
    return tp_size() > 1 and not attn_replicated(cfg)


def head_input(x: torch.Tensor, cfg) -> torch.Tensor:
    """``x`` entering a block's q/k/v projections: through ``tp_input``
    under TP (its gradient summed over the model ranks' head slices), as
    it is where every rank runs every head (the gradient whole there)."""
    return tp_input(x) if _split_heads(cfg) else x


def head_proj(x: torch.Tensor, w, b, cfg, use_kernels: bool,
              heads: int) -> torch.Tensor:
    """A q, k or v projection onto ``heads`` heads: this rank's slice of
    them under TP (``column_linear``), all of them otherwise."""
    if _split_heads(cfg):
        return column_linear(x, w, b, use_kernels, heads * cfg.head_dim)
    return linear(x, w, b, use_kernels)


def out_proj(p: dict, out: torch.Tensor, tap, use_kernels: bool,
              cfg) -> torch.Tensor:
    """``wo`` over the heads ``out [B, S, H, hd]`` (the rank's heads under
    TP, summed over the model group by ``row_linear``; all of them, and
    no sum, where the block replicates), its input tapped."""
    b, s, nh, hd = out.shape
    flat = out.reshape(b, s, nh * hd)
    if tap:
        tap("wo", flat)
    if _split_heads(cfg):
        return row_linear(flat, p["wo"], p.get("bo"), use_kernels,
                          cfg.n_heads * hd)
    return linear(flat, p["wo"], p.get("bo"), use_kernels)


def cross_attn_block(p: dict, x: torch.Tensor, enc_kv: dict, cfg, *,
                     use_kernels: bool = True) -> torch.Tensor:
    """Cross-attention of the encoder-decoder's decoder: queries from
    ``x`` (no rotary), keys and values ``enc_kv["xk"/"xv"] [B, T, KV,
    hd]`` precomputed from the encoder (the rank's KV heads), non-causal.
    Under a mesh it runs the rank's heads as ``attn_block`` does."""
    b, s, _ = x.shape
    hd, nh, _ = (cfg.head_dim,) + rank_heads(cfg)
    q = head_proj(head_input(x, cfg), p["wq"], p.get("bq"), cfg,
                  use_kernels, cfg.n_heads).reshape(b, s, nh, hd)
    k, v = enc_kv["xk"], enc_kv["xv"]
    t = k.shape[1]
    pos_q = torch.arange(s, device=x.device)[None, :].expand(b, s)
    pos_k = torch.arange(t, device=x.device)[None, :].expand(b, t)
    out = attend(q, k, v, q_positions=pos_q, kv_positions=pos_k,
                 causal=False, window=None, attn_softcap=cfg.attn_softcap)
    return out_proj(p, out, None, use_kernels, cfg)


def precompute_cross_kv(p: dict, enc_out: torch.Tensor, cfg,
                        use_kernels: bool = True) -> dict:
    """One decoder layer's cross-attention K/V from the encoder output
    (the rank's KV heads under TP)."""
    b, t, _ = enc_out.shape
    hd, _, nkv = (cfg.head_dim,) + rank_heads(cfg)
    h = head_input(enc_out, cfg)
    k = head_proj(h, p["wk"], p.get("bk"), cfg, use_kernels,
                  cfg.n_kv_heads).reshape(b, t, nkv, hd)
    v = head_proj(h, p["wv"], p.get("bv"), cfg, use_kernels,
                  cfg.n_kv_heads).reshape(b, t, nkv, hd)
    return {"xk": k, "xv": v}
