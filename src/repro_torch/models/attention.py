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
arena then holds every KV head. A contiguous cache on a mesh
(``launch.sharding.local_cache``) holds the rank's rows and the same KV
columns (the rank's ``n_kv / M`` heads, or all of them), so the block
writes and reads its own columns; the cross-attention's cached ``xk`` /
``xv`` hold the rank's KV heads too (``precompute_cross_kv``), where
JAX keeps them whole. With a page slice (a mesh whose data
axis is over 1) the arena holds the rank's slice of the pages: the step's K/V rows land
only in pages of the slice, at ``global - first`` (other rows in the
slice's sink page), the kernel reads the slice's pages, and the slices'
``(o, m, l)`` merge over the data group (``kernels.paged_attention.
merge_over``). Where the serving step splits its lanes over ``data``
(``runtime_context.current_row_axes``) a rank computes q, K and V for
its lanes only and gathers them over ``data`` before the write and the
kernel, which run every lane, and keeps its lanes' rows of the merged
output. A contiguous cache cut over ``data`` by sequence
(``runtime_context.current_seq_slice``: a batch that does not divide the
dp axes) holds the rank's positions: the write lands where it falls in
the cut, and the rank's ``(o, m, l)`` over its positions
(``attend_partial``) merge over ``data`` the same way.
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


def _grouped_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q [B,S,H,D] scaled by D^-1/2 and grouped as [B,S,KV,G,D] in fp32.
    The scale is a fill on the device, not a copy from the host: a CUDA
    graph of the step can capture it."""
    b, s, h, d = q.shape
    scale = torch.full((), d ** -0.5, dtype=q.dtype, device=q.device)
    return (q.reshape(b, s, n_kv, h // n_kv, d) * scale).float()


def _masked_scores(qg: torch.Tensor, k: torch.Tensor,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                   causal: bool, window: Optional[int],
                   live: Optional[torch.Tensor],
                   attn_softcap: Optional[float]):
    """The softcapped scores [B,KV,G,S,T] of ``_grouped_q``'s ``qg``
    against ``k`` [B,T,KV,D], -1e30 where a key is masked (causal, the
    window, or not ``live`` [B,T]), and that mask. Positions are
    absolute token indices, as in the JAX reference."""
    b, s = qg.shape[:2]
    t = k.shape[1]
    scores = softcap(torch.einsum("bskgd,btkd->bkgst", qg, k.float()),
                     attn_softcap)
    pq = q_positions[:, None, None, :, None]
    pk = kv_positions[:, None, None, None, :]
    if live is None:
        mask = torch.ones((b, 1, 1, s, t), dtype=torch.bool, device=qg.device)
    else:
        mask = live[:, None, None, None, :]
    if causal:
        mask = mask & (pk <= pq)
    if window is not None:
        mask = mask & (pq - pk < window)
    return torch.where(mask, scores, torch.full_like(scores, -1e30)), mask


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_positions: torch.Tensor, kv_positions: torch.Tensor,
           kv_valid_len: Optional[torch.Tensor] = None, causal: bool = True,
           window: Optional[int] = None,
           attn_softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,S,H,D]; k,v [B,T,KV,D]; positions are absolute token indices.
    Returns [B,S,H,D]. Masks use -1e30, as the JAX reference."""
    b, s, h, d = q.shape
    live = (None if kv_valid_len is None
            else kv_positions < kv_valid_len[:, None])
    scores, _ = _masked_scores(_grouped_q(q, k.shape[2]), k, q_positions,
                               kv_positions, causal=causal, window=window,
                               live=live, attn_softcap=attn_softcap)
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
    qg = _grouped_q(q, n_kv)
    m = torch.full((b, n_kv, g, s), -1e30, device=q.device)
    l = torch.zeros((b, n_kv, g, s), device=q.device)
    acc = torch.zeros((b, n_kv, g, s, d), device=q.device)
    for c0 in range(0, t, chunk):
        k_c, v_c = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        pk = kv_positions[:, c0:c0 + chunk]
        scores, _ = _masked_scores(qg, k_c, q_positions, pk, causal=causal,
                                   window=window, live=pk < 2 ** 30,
                                   attn_softcap=attn_softcap)
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
                 pos0, cut=None) -> dict:
    """Write K/V of ``s`` tokens at ``pos0`` (an int or a 0-dim tensor)
    into one group's contiguous cache ``[B, T, KV*hd]``, in place; int8
    caches take ``quantize_kv``'s codes and scales. As the reference's
    ``dynamic_update_slice``, a start past ``T - s`` is clamped to it.
    Under a sequence cut (``cut = (first, n, total)``) the cache holds
    positions ``[first, first + n)`` of ``total``: the clamp is taken on
    ``total`` and only the tokens that land in the cut are written, at
    ``global - first``; a multi-token call starts at an int (the
    prefill's 0), a one-token call may start at a tensor (its write
    keeps the old row where it lands elsewhere: no host read)."""
    b, s, n_kv, hd = k.shape
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
    if cut is not None:
        first, n, total = cut
        if isinstance(pos0, torch.Tensor):
            if s != 1:
                raise ValueError("a multi-token write into a cut cache "
                                 "starts at an int")
            g = torch.clamp(pos0.to(torch.int64), 0, total - 1) - first
            own = (g >= 0) & (g < n)
            idx = torch.clamp(g, 0, n - 1).reshape(1).to(k.device)
            for name, val in writes.items():
                old = cache[name].index_select(1, idx)
                cache[name].index_copy_(1, idx, torch.where(own, val, old))
            return cache
        lo = min(max(int(pos0), 0), total - s)
        a, z = max(lo, first), min(lo + s, first + n)
        if a < z:
            idx = torch.arange(a - first, z - first, device=k.device)
            for name, val in writes.items():
                cache[name].index_copy_(1, idx, val[:, a - lo:z - lo])
        return cache
    start = torch.as_tensor(pos0, dtype=torch.int64, device=k.device)
    idx = torch.arange(s, device=k.device) + torch.clamp(
        start, 0, cache["k"].shape[1] - s)
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
        cut = ctx.current_seq_slice()
        if cut is not None:
            return out_proj(p, _sliced_contiguous(
                cache, q, k, v, pos0, cut, positions, valid, window, cfg),
                tap, use_kernels, cfg)
        _cache_write(cache, k, v, pos0)
        k_all, v_all = _cache_read(cache, x.dtype, nkv, hd)
        t_max = k_all.shape[1]
        kv_pos = torch.arange(t_max, device=x.device)[None, :].expand(b, -1)
        out = attend(q, k_all, v_all, q_positions=positions,
                     kv_positions=kv_pos, kv_valid_len=valid, causal=True,
                     window=window, attn_softcap=cfg.attn_softcap)
        return out_proj(p, out, tap, use_kernels, cfg)
    page_slice = ctx.current_page_slice()
    kw = dict(n_kv=nkv, head_dim=hd, window=window,
              attn_softcap=cfg.attn_softcap)
    if ctx.current_row_axes() and page_slice is not None:
        out = _rows_over_slice(cache, q, k, v, kw, use_kernels,
                               paged_attention)
        return out_proj(p, out, tap, use_kernels, cfg)
    paged_cache_write(cache, k, v, positions, valid_len=valid_len,
                      page_slice=page_slice)
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


def _rows_over_slice(cache: dict, q, k, v, kw: dict, use_kernels: bool,
                     paged_attention: bool) -> torch.Tensor:
    """Attention of a rank that runs its lanes' rows (a row split over
    ``data``) over its page slice of the arena: its lanes' ``q | k | v``
    gathered over ``data`` in one all_gather (kind ``rows``), every lane's
    K/V rows that fall in the slice written (the others to the sink),
    the ragged kernel over the slice for every lane, the slices merged
    over ``data`` (``merge_over``), and the rank's lanes' output kept.
    Positions, ``valid_len`` and the block tables are every lane's
    (``runtime_context.current_lanes``)."""
    if not paged_attention:
        raise NotImplementedError(
            "a sliced arena is read through the ragged kernel "
            "(paged_attention=True); the full-width gather needs every "
            "page")
    mesh = ctx.current_mesh()
    lanes = ctx.current_lanes()
    if lanes is None or ctx.current_row_axes() != ("data",):
        raise ValueError("a row split over the page slices needs every "
                         "lane's positions and the rows split over "
                         "'data' alone (serve.steps' mesh step set)")
    positions, valid = lanes
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    fused = torch.cat([q.reshape(b, s, -1), k.reshape(b, s, -1),
                       v.reshape(b, s, -1)], dim=-1)
    fused = mesh.all_gather(fused.contiguous(), "data", 0, kind="rows")
    qa, ka, va = torch.split(fused, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    big = fused.shape[0]
    qa = qa.reshape(big, s, nh, hd)
    page_slice = ctx.current_page_slice()
    paged_cache_write(cache, ka.reshape(big, s, nkv, hd),
                      va.reshape(big, s, nkv, hd), positions,
                      valid_len=valid, page_slice=page_slice)
    call = (kpa.ragged_paged_attention_call if use_kernels
            else ragged_paged_attention_ref)
    o, m, l = call(qa.contiguous(), cache, positions[:, 0], valid,
                   page_slice=page_slice, **kw)
    out = kpa.merge_over(o, m, l, mesh).to(q.dtype)
    first = mesh.index("data") * b
    return out[first:first + b]


def attend_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor,
                   kv_valid_len: torch.Tensor, window: Optional[int] = None,
                   attn_softcap: Optional[float] = None):
    """Causal attention of ``q [B, S, H, D]`` over one slice of the keys
    (``k``, ``v`` ``[B, T, KV, D]`` at absolute ``kv_positions``), in the
    form slices merge in (``kernels.paged_attention.merge_over``): ``(o
    [B, S, H, D] fp32, m [B, S, H], l [B, S, H])``, ``o`` normalised over
    the slice's live keys, a row with none ``(0, -1e30, 0)``. Masked
    probabilities are zeroed explicitly (a row whose every score is
    masked would otherwise weigh its keys evenly)."""
    b, s, h, d = q.shape
    scores, mask = _masked_scores(
        _grouped_q(q, k.shape[2]), k, q_positions, kv_positions,
        causal=True, window=window,
        live=kv_positions < kv_valid_len[:, None], attn_softcap=attn_softcap)
    m = scores.amax(dim=-1)                              # [B,KV,G,S]
    p = torch.where(mask, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgst,btkd->bkgsd", p, v.float())
    o = o / torch.clamp_min(l, 1e-30)[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return (o, m.permute(0, 3, 1, 2).reshape(b, s, h),
            l.permute(0, 3, 1, 2).reshape(b, s, h))


def _sliced_contiguous(cache: dict, q, k, v, pos0, cut, positions, valid,
                       window, cfg) -> torch.Tensor:
    """Attention over a contiguous cache cut over ``data`` (``cut =
    (first, n, total)``: the rank holds positions ``[first, first + n)``
    of ``total``): the step's K/V written at the positions of the cut
    (``_cache_write`` at the global position, clamped as the reference
    clamps), the rank's ``(o, m, l)`` over its positions at their global
    key positions (the causal mask, the window and ``valid``), merged
    over ``data`` (``merge_over``)."""
    first, n, total = cut
    b, s, nkv, hd = k.shape
    _cache_write(cache, k, v, pos0, cut)
    k_all, v_all = _cache_read(cache, q.dtype, nkv, hd)
    kv_pos = (first + torch.arange(n, device=q.device))[None, :].expand(
        b, -1)
    o, m, l = attend_partial(q, k_all, v_all, q_positions=positions,
                             kv_positions=kv_pos, kv_valid_len=valid,
                             window=window, attn_softcap=cfg.attn_softcap)
    return kpa.merge_over(o, m, l, ctx.current_mesh()).to(q.dtype)


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
