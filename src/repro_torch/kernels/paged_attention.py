"""Wrapper of the ragged paged-attention kernel
(``csrc/paged_attention.cu``; its decode path in
``csrc/paged_attention_decode.cu``), the counterpart of
``repro.kernels.paged_attention.ragged_paged_attention``.

ONE kernel serves every attention read of the serving step: decode lanes
(one query token), prefill chunks (a block of query tokens scattered into
the arena just before) and idle lanes (``n_new = 0``, all rows dead), in
the same call. Lane ``b``'s queries sit at ``q_start[b] + t`` and attend
the pages of ``block_tbl[b]`` causally, bounded by ``kv_len[b]``; query
rows at or past ``kv_len`` emit exactly 0.

The kernel walks each (lane, KV head, q block)'s causally live pages only
(``live_pages``), and under a sliding window only from the window's first
page on (``first_page``: the page of the first key the block's first
query sees). A q block is ``Q_BLOCK`` tokens, halved by ``q_block_for``
where its rows and page ring outgrow a block's shared memory (hd 128 at
G = 6 over fp32 pages, dbrx-132b: 8 tokens). The same ``q_block_for``
sets the block of the host-side stream account
(``memsys.workload.chunk_pages_streamed``, the engine's
``prefill_kv_pages_live`` counter), which counts every causally live page
as the reference does: without a window it equals the pages the kernel
walks, under a window the kernel reads fewer (``live_pages(...,
window=)``). The walk is cut into spans of ``span_pages`` pages, one
block each (split-KV); ``span_plan`` lists the page ranges the span
blocks walk, and the kernel's second pass merges the spans of a row in
span order.

q may be fp32 or bf16 and the pages fp32, bf16 or int8 (with bf16
scales), and the kernel returns ``(o, m, l)`` in fp32;
``ragged_paged_attention`` casts ``o`` to q's dtype. It takes one of
three routes (``route``, counted in ``route_launches``): bf16 q over bf16
pages runs bf16 tensor-core products (``"bf16-mma"``: q times K exact in
fp32, p as bf16 hi + lo against V); otherwise q and the pages are widened
to fp32 as they are read, as the reference casts them, and a chunk runs
TF32 tensor-core products at fp32 accuracy (``"tf32"``), a decode step
fp32 warp-shuffle dots (``"shuffle"``).

A page slice ``(first, n)`` (JAX's ``meta``) says that the pages passed
hold global pages ``[first, first + n)`` of the arena, a data rank's slice
on a mesh: block-table entries are global page ids, an entry outside the
slice contributes nothing, and a row with no live page in the slice
returns ``o = 0``, ``m = -1e30``, ``l = 0``. The kernel resolves the slice
where it plans spans: a span is a chunk of a run of consecutive live
entries in the slice (``slice_runs``), so its pages' key positions stay
linear and the inner loops are those of an unsliced call. ``merge_slices`` and
``merge_over`` combine the ``(o, m, l)`` of the slices, as JAX's
``pmax``/``psum`` merge does. Without a slice every entry is a local page
(the slice ``(0, n_pages)``).

On a CPU tensor the wrapper runs the plain version
(``kernels.ref.ragged_paged_attention_ref``); on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import ragged_paged_attention_ref

Q_BLOCK = 16
STAGE_KEYS = 64           # keys per stage of the kernel's page ring
_BLOCKS_PER_SM = 2        # span blocks in flight per SM the split aims for
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may opt into
# decode path: ceil(hd / 32) dims per lane (hd 80 on the hd-96 tiling)
_DECODE_HD = (32, 64, 80, 128, 256)
_CHUNK_HD = (32, 64, 80, 128, 256)   # chunk path: hd / 8 mma n tiles
_MAX_G = 8                # decode rows (G) / chunk 16-row m tiles
# the kernel's page kinds (csrc/paged_attention.cuh: Kind) and their bytes
_PAGE_KIND = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}
_KIND_BYTES = {0: 4, 1: 1, 2: 2}
# the kernel's routes (csrc/paged_attention.cuh: Route) and their launches
ROUTES = ("tf32", "bf16-mma", "shuffle")
route_launches = {r: 0 for r in ROUTES}


def stage_keys(hd: int, kind: int) -> int:
    """Keys per ring stage (``csrc/paged_attention.cuh:stage_keys``):
    ``STAGE_KEYS``, or half of it where a page row is over 512 bytes (fp32
    pages at hd 256), so that two stages fit a block's shared memory."""
    return STAGE_KEYS // 2 if hd * _KIND_BYTES[kind] > 512 else STAGE_KEYS


def first_page(q0: int, page: int, window: Optional[int] = None) -> int:
    """First page the kernel walks for a q block whose first query sits at
    ``q0``: the page of the first key that query sees under the window,
    ``max(0, q0 - window + 1) // page`` (no row of the block sees a key
    below it); 0 without a window (``csrc/paged_attention.cuh:
    first_page``)."""
    return max(0, q0 - window + 1) // page if window else 0


def live_pages(q_start: int, kv_len: int, qb: int, q_blk: int,
               page: int, window: Optional[int] = None) -> int:
    """Causally live pages of q block ``qb`` of one lane: 0 when the block
    is dead (its first position is at or past ``kv_len``), else
    ``ceil(min(kv_len, q_start + (qb+1)*q_blk) / page)``; under a
    ``window``, those from ``first_page`` on (the pages the kernel
    walks)."""
    q0 = q_start + qb * q_blk
    if q0 >= kv_len:
        return 0
    return (-(-min(kv_len, q0 + q_blk) // page)
            - first_page(q0, page, window))


def walk_width(n_tbl: int, page: int, q_blk: int,
               window: Optional[int] = None) -> int:
    """The most pages one (lane, q block) walks over ``[., n_tbl]``
    tables: ``n_tbl``, or under a window ``min(n_tbl, ceil((window + q_blk
    - 1) / page) + 1)`` (its rows see keys ``[q0 - window + 1, q0 + q_blk
    - 1]``). The wrapper sizes the span split, the grid and the partial
    workspace by it."""
    if not window:
        return n_tbl
    return min(n_tbl, -(-(window + q_blk - 1) // page) + 1)


def slice_runs(tbl_row, n: int, page_slice, lo: int = 0) -> list:
    """The runs ``[p0, p1)`` of consecutive entries among a lane's table
    entries ``[lo, n)`` (global page ids) that lie in ``page_slice =
    (first, pages)``: what a sliced call walks."""
    first, n_slice = page_slice
    runs, start = [], None
    for p in range(lo, n + 1):
        inside = p < n and 0 <= int(tbl_row[p]) - first < n_slice
        if inside and start is None:
            start = p
        elif not inside and start is not None:
            runs.append((start, p))
            start = None
    return runs


def span_pages(n_items: int, n_tbl: int, page: int, n_sm: int = 132,
               keys: int = STAGE_KEYS) -> int:
    """Pages per span: the ``n_items`` (lane, KV head, q block) work items
    times the spans of a full ``n_tbl``-page table come to about
    ``_BLOCKS_PER_SM`` blocks per SM; a span is whole ring stages of
    ``keys`` keys (``stage_keys``)."""
    unit = max(1, keys // page)
    want = max(1, -(-_BLOCKS_PER_SM * n_sm // max(n_items, 1)))
    per = -(-max(n_tbl, 1) // want)
    return max(unit, -(-per // unit) * unit)


def smem_bytes(rows: int, q_blk: int, hd: int, kind: int,
               n_span_pages: int, q_bf16: bool = False) -> int:
    """Dynamic shared memory of one span block over ``rows = q_blk * G``
    query rows (``csrc/paged_attention.cu:smem_bytes`` and the ``Layout``
    of ``paged_attention.cuh``, which the card test holds it to): the
    span's table, the page ring (three stages while two blocks fit an SM,
    else two, decided on fp32 q rows; always two on the bf16-mma route's
    chunk path) or the warps' final states over it, and a chunk's q rows
    as fp32 hi + lo, or as bf16 on the bf16-mma route (``q_bf16`` over bf16
    pages), which so never needs more."""
    chunk = q_blk > 1
    keys = stage_keys(hd, kind)
    tiles = keys // 16        # 16-key warp work items per ring stage
    if chunk:
        mt = -(-rows // 16)
        rows_pad = mt * 16
        groups = tiles // mt if mt <= tiles and tiles % mt == 0 else 1
    else:
        rows_pad = next(r for r in (1, 2, 4, 8) if rows <= r or r == 8)
        groups = tiles
    rb = hd * _KIND_BYTES[kind]
    k_row = rb + (32 if kind == 0 else 16)
    stage = keys * (k_row + rb + 16) + (8 * keys if kind == 1 else 0)
    tbl = -(-n_span_pages * 4 // 16) * 16
    q = 2 * rows_pad * (hd + 8) * 4 if chunk else 0
    # the bf16-mma route's q rows: bf16, not fp32 hi + lo
    q_mma = rows_pad * (hd + 8) * 2 if chunk else 0
    mma16 = q_bf16 and kind == _PAGE_KIND[torch.bfloat16]
    scratch = groups * rows_pad * (hd + 2) * 4
    for stages in (3, 2):   # decided on fp32 q rows; a bf16-mma chunk: 2
        total = tbl + max(stages * stage, scratch) + q
        if stages == 2 or (total <= 113 * 1024 and not (mma16 and chunk)):
            return total - q + q_mma if mma16 else total


def q_block_for(g: int, hd: int, page_dtype: torch.dtype, n_tbl: int,
                page: int) -> int:
    """Tokens per q block of a chunk call over ``[., n_tbl]`` tables:
    ``Q_BLOCK``, halved while a block's rows and page ring at the widest
    span such a table can give outgrow a block's shared memory. A call of
    width ``s`` runs ``min(q_block_for(...), s)``; the engine's stream
    account counts with the same block (pages the kernel does not take
    keep ``Q_BLOCK``). It sizes q rows as fp32 hi + lo, so a bf16 q (whose
    rows take less) gets the same block."""
    kind = _PAGE_KIND.get(page_dtype)
    if kind is None:
        return Q_BLOCK
    unit = max(1, stage_keys(hd, kind) // page)
    widest = max(unit, -(-max(n_tbl, 1) // unit) * unit)
    blk = Q_BLOCK
    while blk > 2 and smem_bytes(blk * g, blk, hd, kind,
                                 widest) > _SMEM_LIMIT:
        blk //= 2
    return blk


def span_plan(q_start, kv_len, s: int, page: int, n_span_pages: int,
              q_block: int = Q_BLOCK, tbl=None, page_slice=None,
              window: Optional[int] = None) -> list:
    """The page ranges ``[p0, p1)`` the span blocks of each (lane, q block)
    walk, per lane and q block, for queries of width ``s`` in blocks of
    ``min(q_block, s)`` tokens (what the kernel computes on the card from
    the same rule): the live pages from ``first_page`` on (page 0 without
    a ``window``). With a ``page_slice`` (and the tables ``tbl [B, P]``)
    the spans are each run of the slice's walked pages (``slice_runs``)
    cut into ``n_span_pages`` from its start."""
    q_blk = min(q_block, s)
    out = []
    for b, (qs, kl) in enumerate(zip(q_start, kv_len)):
        lane = []
        for qb in range(-(-s // q_blk)):
            n = live_pages(int(qs), int(kl), qb, q_blk, page)
            lo = first_page(int(qs) + qb * q_blk, page, window) if n else 0
            runs = [(lo, n)] if page_slice is None else slice_runs(
                tbl[b], n, page_slice, lo)
            lane.append([(p0, min(r1, p0 + n_span_pages))
                         for r0, r1 in runs
                         for p0 in range(r0, r1, n_span_pages)])
        out.append(lane)
    return out


def n_spans_for(width: int, n_span_pages: int, n_slice: int = 0) -> int:
    """Span blocks of the grid (and partials of the workspace) for walks
    of at most ``width`` pages: ``ceil(width / n_span_pages)``; over a
    page slice of ``n_slice`` pages, at most ``ceil(width / 2)`` runs (an
    entry outside the slice parts two) plus ``width // n_span_pages``
    chunks (``csrc/paged_attention.cuh:span_of``)."""
    if not n_slice:
        return max(1, -(-width // n_span_pages))
    return max(1, min(width, n_slice,
                      (width + 1) // 2 + width // n_span_pages))


@functools.lru_cache(maxsize=None)
def route(q_blk: int, q_bf16: bool, kind: int) -> str:
    """The route the library takes for a call (``csrc/paged_attention.cuh:
    route_of``): ``"bf16-mma"``, ``"tf32"`` or ``"shuffle"``."""
    return ROUTES[build.library().qmc_ragged_paged_attention_route(
        q_blk, int(q_bf16), kind)]


def shard_compatible(mesh, n_pages_total: int) -> bool:
    """Whether the arena divides the mesh: the page axis over ``data``
    (equal page slices). The KV heads need not divide ``model``: where
    they do not, every model rank holds all of them
    (``launch.sharding.local_arena``)."""
    if mesh is None:
        return True
    from repro_torch.launch.mesh import axis_size
    return n_pages_total % max(axis_size(mesh, "data"), 1) == 0


def merge_slices(parts) -> torch.Tensor:
    """The output of the whole arena from the ``(o, m, l)`` of its page
    slices, in slice order: JAX's merge, ``num / max(den, 1e-30)`` with
    ``w = exp(m - max m) * l``."""
    mg = parts[0][1]
    for _, m, _ in parts[1:]:
        mg = torch.maximum(mg, m)
    num = den = None
    for o, m, l in parts:
        w = torch.exp(m - mg) * l
        num = o * w[..., None] if num is None else num + o * w[..., None]
        den = w if den is None else den + w
    return num / torch.clamp_min(den, 1e-30)[..., None]


def merge_over(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, mesh,
               axis: str = "data") -> torch.Tensor:
    """``merge_slices`` across the ranks of ``axis``: one all_reduce MAX of
    ``m``, then one all_reduce SUM of ``[o * w, w]`` packed together (kind
    ``merge``)."""
    mg = mesh.all_reduce(m.clone(), axis, "max", kind="merge")
    w = torch.exp(m - mg) * l
    packed = mesh.all_reduce(torch.cat([o * w[..., None], w[..., None]],
                                       dim=-1), axis, "sum",
                            kind="merge")
    return packed[..., :-1] / torch.clamp_min(packed[..., -1], 1e-30)[
        ..., None]


def _check(q, cache, n_kv, head_dim, page_slice=None) -> Tuple[int, int]:
    """Raise on what the kernel does not take; return the page kind and
    the call's q block."""
    if q.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or q.ndim != 4:
        raise TypeError("q must be a float32 or bfloat16 [B, S, H, hd] "
                        "tensor")
    b, _, h, hd = q.shape
    if hd != head_dim or h % n_kv:
        raise ValueError((tuple(q.shape), n_kv, head_dim))
    kp, vp = cache["k_pages"], cache["v_pages"]
    if kp.ndim != 3 or kp.shape[-1] != n_kv * hd or kp.shape != vp.shape:
        raise ValueError("k/v pages must be [n_pages, page, KV*hd]")
    quantized = "k_scale_pages" in cache
    tensors = [kp, vp]
    if quantized and kp.dtype != torch.int8:
        raise TypeError("k/v pages with scales must be int8")
    if kp.dtype not in _PAGE_KIND or (not quantized
                                       and kp.dtype == torch.int8) \
            or vp.dtype != kp.dtype:
        raise TypeError(f"k/v pages must be float32 or bfloat16, or int8 "
                        f"with scales; got {kp.dtype}, {vp.dtype}")
    if quantized:
        ks, vs = cache["k_scale_pages"], cache["v_scale_pages"]
        if ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16 \
                or tuple(ks.shape) != (kp.shape[0], kp.shape[1], n_kv) \
                or ks.shape != vs.shape:
            raise TypeError("int8 pages need bf16 scales [n_pages, page, KV]")
        tensors += [ks, vs]
    tbl = cache["block_tbl"]
    if tbl.dtype != torch.int32 or tbl.ndim != 2 or tbl.shape[0] != b:
        raise TypeError("block_tbl must be int32 [B, P]")
    for t in tensors:
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"arena pages must be contiguous and 16-byte "
                             f"aligned on {q.device}")
    # the kernels read the table one int32 at a time: a group's row of a
    # [G, B, P] table starts at any multiple of 4 bytes
    if tbl.device != q.device or not tbl.is_contiguous():
        raise ValueError(f"block_tbl must be contiguous on {q.device}")
    page = kp.shape[1]
    keys = stage_keys(hd, _PAGE_KIND[kp.dtype])
    if keys % page:
        raise ValueError(f"page size {page} must divide the {keys} keys of "
                         f"a ring stage (hd {hd}, {kp.dtype} pages)")
    if quantized and (hd % 16 or ks.numel() % 2):
        raise ValueError("int8 pages need hd % 16 == 0 and an even number "
                         "of scales (16-byte rows, 4-byte scale words)")
    if page_slice is not None:
        first, n_slice = page_slice
        if n_slice <= 0 or first < 0 or n_slice > kp.shape[0]:
            raise ValueError(f"page slice {page_slice} over the "
                             f"{kp.shape[0]} pages passed")
    g = h // n_kv
    q_blk = min(q_block_for(g, hd, kp.dtype, tbl.shape[1], page),
                q.shape[1])
    if q_blk == 1 and (hd not in _DECODE_HD or g > _MAX_G):
        raise ValueError(f"decode path takes hd in {_DECODE_HD} and G <= "
                         f"{_MAX_G}, got hd {hd}, G {g}")
    if q_blk > 1 and (hd not in _CHUNK_HD or -(-q_blk * g // 16) > _MAX_G):
        raise ValueError(f"chunk path takes hd in {_CHUNK_HD} and "
                         f"{q_blk} x G <= {16 * _MAX_G} rows, got hd {hd}, "
                         f"G {g}")
    return _PAGE_KIND[kp.dtype], q_blk


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ragged_paged_attention_call(
        q: torch.Tensor, cache: dict, q_start: torch.Tensor,
        kv_len: torch.Tensor, *, n_kv: int, head_dim: int,
        window: Optional[int] = None, attn_softcap: Optional[float] = None,
        page_slice: Optional[Tuple[int, int]] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(o [B, S, H, hd], m, l [B, S, H])`` in fp32, whatever the
    dtypes of q and the pages: the output plus every row's softmax max and
    sum (what a cross-device merge of partial results needs). With
    ``page_slice = (first, n)`` the pages hold global pages ``[first,
    first + n)`` (see the module docstring)."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, cache, q_start, kv_len, n_kv=n_kv, head_dim=head_dim,
            window=window, attn_softcap=attn_softcap,
            page_slice=page_slice)
    kind, q_blk = _check(q, cache, n_kv, head_dim, page_slice)
    b, s, h, hd = q.shape
    g = h // n_kv
    tbl = cache["block_tbl"]
    page, n_tbl = cache["k_pages"].shape[1], tbl.shape[1]
    lib = build.library()
    quantized = "k_scale_pages" in cache
    qb_n = -(-s // q_blk)
    s_pad = qb_n * q_blk
    first, n_slice = page_slice if page_slice is not None else (0, 0)
    # the widest walk (under a window, from its first page) sets the span
    # split, the grid and the workspace
    width = walk_width(n_tbl, page, q_blk, window)
    sp = span_pages(b * n_kv * qb_n, width, page, _sm_count(q.device),
                    stage_keys(hd, kind))
    n_spans = n_spans_for(width, sp, n_slice)
    q_bf16 = q.dtype == torch.bfloat16
    smem = lib.qmc_ragged_paged_attention_smem(q_blk * g, q_blk, hd, kind,
                                               sp, int(q_bf16))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"kernel needs {smem} B of shared memory "
                         f"(> {_SMEM_LIMIT})")
    qp = q if s_pad == s else F.pad(q, (0, 0, 0, 0, 0, s_pad - s))
    qp = qp.contiguous()
    if qp.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned (the kernel copies q "
                         "rows in 16-byte pieces)")
    qs = q_start.to(device=q.device, dtype=torch.int32).contiguous()
    kl = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    if qs.shape != (b,) or kl.shape != (b,):
        raise ValueError("q_start and kv_len must be [B]")
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((b, s_pad, h, hd), **f32)
    m = torch.empty((b, s_pad, h), **f32)
    l = torch.empty_like(m)
    po = pm = pl = None
    if n_spans > 1:   # the spans' partial (o * l, m, l), merged in order
        po = torch.empty((n_spans, b, s_pad, h, hd), **f32)
        pm = torch.empty((n_spans, b, s_pad, h), **f32)
        pl = torch.empty_like(pm)
    ks = cache["k_scale_pages"].data_ptr() if quantized else None
    vs = cache["v_scale_pages"].data_ptr() if quantized else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.qmc_ragged_paged_attention(
            qp.data_ptr(), cache["k_pages"].data_ptr(),
            cache["v_pages"].data_ptr(), ks, vs, tbl.data_ptr(),
            qs.data_ptr(), kl.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), *(t.data_ptr() if t is not None else None
                            for t in (po, pm, pl)),
            b, s_pad, h, n_kv, hd, page, n_tbl, q_blk,
            int(window) if window is not None else 0,
            float(attn_softcap) if attn_softcap else 0.0,
            float(hd) ** -0.5, int(q_bf16), kind, sp,
            n_spans, first, n_slice, stream)
    build.check(rc, "ragged_paged_attention")
    build.count_launch("ragged_paged_attention")
    route_launches[route(q_blk, q_bf16, kind)] += 1
    return o[:, :s], m[:, :s], l[:, :s]


def ragged_paged_attention(
        q: torch.Tensor, cache: dict, q_start: torch.Tensor,
        kv_len: torch.Tensor, *, n_kv: int, head_dim: int,
        window: Optional[int] = None, attn_softcap: Optional[float] = None
        ) -> torch.Tensor:
    """Ragged multi-query attention straight off the paged arena (the
    whole arena: no page slice).

    q ``[B, S, H, hd]``; ``cache`` holds ``k_pages/v_pages [n_pages, page,
    KV*hd]`` (int8 layouts add ``{k,v}_scale_pages [n_pages, page, KV]``)
    and ``block_tbl [B, P]``; ``kv_len [B]`` is each lane's valid KV bound
    (``q_start + n_new`` for a chunk just scattered). Returns ``[B, S, H,
    hd]`` in q's dtype."""
    o, _, _ = ragged_paged_attention_call(
        q, cache, q_start, kv_len, n_kv=n_kv, head_dim=head_dim,
        window=window, attn_softcap=attn_softcap)
    return o.to(q.dtype)
