"""Host-side planning of the port's split kernels, on the CPU.

The ragged paged-attention kernel cuts each (lane, KV head, q block)'s
causally live pages into spans, one block each, and merges them in span
order; the column-strip qmm splits K over blocks. Both plans are plain
Python (``kernels.paged_attention.span_pages`` / ``span_plan`` /
``live_pages``, ``kernels.qmm.colstrip_splits``) that the kernels mirror.
These tests hold the attention plan to the stream account the serving
engine keeps: every causally live page is visited exactly once, and the
live-page total equals ``memsys.workload.chunk_pages_streamed`` (the
engine's ``prefill_kv_pages_live`` counter), in the port and in the JAX
package; where the kernel halves its q block (``q_block_for``), the
engine counts with the halved block. Under a sliding window the kernel
walks from the window's first page (``first_page``): exactly the pages
some live row of the block sees, within the grid and workspace the
wrapper sizes by ``walk_width``."""
import numpy as np
import pytest
import torch

from repro.memsys.workload import chunk_pages_streamed as jax_streamed
from repro_torch.kernels.paged_attention import (Q_BLOCK, STAGE_KEYS,
                                                 live_pages, n_spans_for,
                                                 q_block_for, smem_bytes,
                                                 span_pages, span_plan,
                                                 stage_keys, walk_width)
from repro_torch.kernels.qmm import COLSTRIP_BM, colstrip_splits
from repro_torch.memsys.workload import chunk_pages_streamed
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Request, ServeEngine


def _lanes(seed: int, n: int, s: int, max_start: int):
    """Random (q_start, n_new) lanes for a step of width s: idle lanes,
    decode lanes and chunks of up to s tokens."""
    rng = np.random.default_rng(seed)
    lanes = []
    for _ in range(n):
        kind = rng.integers(3)
        n_new = 0 if kind == 0 else 1 if kind == 1 else int(
            rng.integers(1, s + 1))
        lanes.append((int(rng.integers(0, max_start)), n_new))
    return lanes


CASES = [  # (seed, lanes, S, page, max start, SMs)
    (0, 4, 1, 16, 4096, 132),      # long-context decode
    (1, 4, 128, 16, 256, 132),     # prefill chunks
    (2, 8, 64, 16, 512, 132),      # a mixed ragged step
    (3, 6, 40, 8, 300, 132),
    (4, 5, 17, 32, 700, 16),       # few SMs: many spans
    (5, 3, 1, 64, 9000, 132),
    (6, 7, 3, 2, 90, 132),
]


@pytest.mark.parametrize("seed,n,s,page,max_start,n_sm", CASES)
def test_span_plan_visits_every_live_page_once(seed, n, s, page, max_start,
                                               n_sm):
    lanes = _lanes(seed, n, s, max_start)
    q_start = [a for a, _ in lanes]
    kv_len = [a + b for a, b in lanes]
    q_blk = min(Q_BLOCK, s)
    qb_n = -(-s // q_blk)
    n_tbl = max(-(-kl // page) for kl in kv_len) + 1
    sp = span_pages(n * 4 * qb_n, n_tbl, page, n_sm)
    plan = span_plan(q_start, kv_len, s, page, sp)
    for (qs, kl), lane in zip(zip(q_start, kv_len), plan):
        assert len(lane) == qb_n
        for qb, spans in enumerate(lane):
            q0 = qs + qb * q_blk
            # pages causally visible to some live row of the block
            want = set()
            for pos_q in range(q0, min(kl, q0 + q_blk)):
                want |= {p for p in range(n_tbl) if p * page <= pos_q}
            visited = [p for p0, p1 in spans for p in range(p0, p1)]
            assert len(visited) == len(set(visited))      # once each
            assert set(visited) == want                   # all, no more
            assert len(spans) <= -(-n_tbl // sp)          # within the grid
            assert all(p1 - p0 <= sp for p0, p1 in spans)
            assert len(visited) == live_pages(qs, kl, qb, q_blk, page)


WINDOWS = {  # window as a function of (page, the largest kv_len)
    "w1": lambda page, top: 1,
    "page-1": lambda page, top: page - 1,
    "page": lambda page, top: page,
    "3page+5": lambda page, top: 3 * page + 5,
    "past-kv": lambda page, top: top + 1,
}


@pytest.mark.parametrize("wname", list(WINDOWS))
@pytest.mark.parametrize("seed,n,s,page,max_start,n_sm", CASES)
def test_windowed_span_plan_walks_only_what_the_window_reaches(
        seed, n, s, page, max_start, n_sm, wname):
    """Under a window the plan visits exactly the pages that some live row
    of the block sees (keys ``[pos - window + 1, pos]``), each once, in
    spans that fit the wrapper's windowed grid and workspace; over a page
    slice, exactly those of them in the slice; a window past every
    kv_len gives the unwindowed plan, and ``window=None`` today's."""
    lanes = _lanes(seed, n, s, max_start)
    q_start = [a for a, _ in lanes]
    kv_len = [a + b for a, b in lanes]
    window = WINDOWS[wname](page, max(kv_len))
    q_blk = min(Q_BLOCK, s)
    qb_n = -(-s // q_blk)
    n_tbl = max(-(-kl // page) for kl in kv_len) + 1
    width = walk_width(n_tbl, page, q_blk, window)
    assert width <= n_tbl
    sp = span_pages(n * 4 * qb_n, width, page, n_sm)
    plan = span_plan(q_start, kv_len, s, page, sp, window=window)
    # a table of distinct page ids, and a slice holding half of them
    rng = np.random.default_rng(seed + 100)
    tbl = rng.permutation(len(lanes) * n_tbl).reshape(len(lanes), n_tbl)
    cut = (len(lanes) * n_tbl // 3, len(lanes) * n_tbl // 2)
    sliced = span_plan(q_start, kv_len, s, page, sp, tbl=tbl,
                       page_slice=cut, window=window)
    for b, (qs, kl) in enumerate(zip(q_start, kv_len)):
        for qb in range(qb_n):
            q0 = qs + qb * q_blk
            want = set()
            for pos_q in range(q0, min(kl, q0 + q_blk)):
                lo = max(0, pos_q - window + 1)
                want |= {p for p in range(n_tbl)
                         if p * page <= pos_q and (p + 1) * page > lo}
            for spans, keep, n_sp in (
                    (plan[b][qb], want, n_spans_for(width, sp)),
                    (sliced[b][qb],
                     {p for p in want if 0 <= tbl[b, p] - cut[0] < cut[1]},
                     n_spans_for(width, sp, cut[1]))):
                visited = [p for p0, p1 in spans for p in range(p0, p1)]
                assert len(visited) == len(set(visited))  # once each
                assert set(visited) == keep               # all, no more
                assert len(spans) <= n_sp                 # within the grid
                assert all(p1 - p0 <= sp for p0, p1 in spans)
            assert len(want) == live_pages(qs, kl, qb, q_blk, page, window)
            assert len(want) <= width
    unwindowed = span_plan(q_start, kv_len, s, page, sp)
    assert span_plan(q_start, kv_len, s, page, sp, window=None) == unwindowed
    if wname == "past-kv":
        assert plan == unwindowed
        assert sliced == span_plan(q_start, kv_len, s, page, sp, tbl=tbl,
                                   page_slice=cut)


@pytest.mark.parametrize("seed,n,s,page,max_start,n_sm", CASES)
def test_span_plan_total_is_the_engines_stream_account(seed, n, s, page,
                                                       max_start, n_sm):
    lanes = _lanes(seed, n, s, max_start)
    q_start = [a for a, _ in lanes]
    kv_len = [a + b for a, b in lanes]
    n_tbl = max(-(-kl // page) for kl in kv_len) + 1
    for sp in (1, span_pages(n * 4, n_tbl, page, n_sm), n_tbl + 5):
        plan = span_plan(q_start, kv_len, s, page, sp)
        for (qs, n_new), lane in zip(lanes, plan):
            total = sum(p1 - p0 for spans in lane for p0, p1 in spans)
            if s >= Q_BLOCK or n_new <= 1:
                # the engine's q block: 16 tokens (a decode step's width
                # 1 covers the same pages)
                assert total == chunk_pages_streamed(qs, n_new, page=page)
                assert total == jax_streamed(qs, n_new, page=page)
            assert total == chunk_pages_streamed(qs, n_new, page=page,
                                                 q_block=min(Q_BLOCK, s))


@pytest.mark.parametrize("keys", [STAGE_KEYS, STAGE_KEYS // 2])
@pytest.mark.parametrize("page", [1, 2, 8, 16, 32, 64])
@pytest.mark.parametrize("n_items,n_tbl,n_sm", [
    (128, 256, 132), (1024, 17, 132), (4, 1, 132), (1, 4096, 132),
    (128, 17, 132), (256, 300, 16)])
def test_span_pages_are_whole_ring_stages(page, n_items, n_tbl, n_sm,
                                          keys):
    sp = span_pages(n_items, n_tbl, page, n_sm, keys)
    assert sp * page % keys == 0 or page > keys
    assert sp >= 1
    n_spans = -(-n_tbl // sp)
    # enough blocks to fill the card unless the table runs out of stages
    unit = max(1, keys // page)
    if sp > unit:
        assert n_items * n_spans >= 2 * n_sm or n_spans * sp >= n_tbl


@pytest.mark.parametrize("m,k,n", [(128, 2048, 2048), (128, 5632, 2048),
                                   (512, 2048, 5632), (512, 5632, 2048),
                                   (512, 2048, 100352), (256, 2048, 2048)])
def test_colstrip_split_takes_the_fewest_rounds(m, k, n):
    """No feasible split (>= 8 K steps each) needs 5% fewer rounds of 264
    resident blocks times K steps per block than the one taken; the
    lm_head's 784 strips fill the card unsplit."""
    splits, rows = colstrip_splits(m, k, n)
    assert splits == 1 or n < 100352
    tiles = (n // 128) * (m // COLSTRIP_BM)
    assert rows % 32 == 0 and splits * rows >= k > (splits - 1) * rows

    def cost(s, per):
        return -(-tiles * s // 264) * per
    steps = k // 32
    for want in range(1, steps // 8 + 1):
        per = -(-steps // want)
        assert cost(splits, rows // 32) <= 1.05 * cost(-(-steps // per), per)


@pytest.mark.parametrize("g,hd,dtype,n_tbl,page,want", [
    (6, 128, torch.float32, 16, 16, 8),      # dbrx-132b, fp32 pages
    (6, 128, torch.float32, 8192, 16, 8),    # a 128K-token table
    (6, 128, torch.bfloat16, 16, 16, 16),
    (6, 128, torch.int8, 16, 16, 16),
    (5, 64, torch.float32, 128, 16, 16),     # hymba-1.5b
    (1, 64, torch.float32, 256, 16, 16),     # stablelm-1.6b
    (8, 128, torch.float32, 16, 16, 8),
    (1, 80, torch.float32, 256, 16, 16),     # stablelm-3b
    (1, 80, torch.int8, 256, 16, 16),
    (2, 256, torch.float32, 512, 16, 16),    # gemma2-2b, 32-key stages
    (2, 256, torch.bfloat16, 512, 16, 16),
    (2, 256, torch.int8, 512, 16, 16),
    (8, 256, torch.float32, 512, 16, 4)])
def test_q_block_halves_only_where_shared_memory_overflows(g, hd, dtype,
                                                           n_tbl, page,
                                                           want):
    """The kernel's q block is the largest of 16, 8, ... whose rows and
    page ring fit a block's shared memory at the widest span the table
    can give."""
    blk = q_block_for(g, hd, dtype, n_tbl, page)
    assert blk == want
    kind = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}[dtype]
    unit = stage_keys(hd, kind) // page
    widest = -(-n_tbl // unit) * unit
    assert smem_bytes(blk * g, blk, hd, kind, widest) <= 227 * 1024
    if blk < Q_BLOCK:
        assert smem_bytes(2 * blk * g, 2 * blk, hd, kind,
                          widest) > 227 * 1024


@pytest.mark.parametrize("hd,kind,want", [
    (32, 0, 64), (64, 0, 64), (80, 0, 64), (128, 0, 64), (256, 0, 32),
    (80, 1, 64), (256, 1, 64), (80, 2, 64), (256, 2, 64)])
def test_stage_keys_halve_only_past_512_byte_rows(hd, kind, want):
    """A ring stage holds 64 keys unless a page row is over 512 bytes
    (fp32 at hd 256), where two 64-key stages (268 KB) would outgrow a
    block's shared memory; at 32 keys both paths fit at gemma2-2b's
    shapes, with the widest span its 8192-token context can give."""
    assert stage_keys(hd, kind) == want
    if (hd, kind) == (256, 0):
        big = 64 * (hd * 4 + 32 + hd * 4 + 16) * 2
        assert big > 227 * 1024
        for q_blk, g in ((1, 2), (16, 2)):
            assert smem_bytes(q_blk * g, q_blk, hd, kind, 512) \
                <= 227 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_prefill_account_uses_the_kernels_q_block(dtype):
    """At hd 128 and G = 6 over fp32 pages (dbrx-132b's attention) the
    kernel runs 8-token q blocks, which re-stream their causal pages: the
    engine's ``prefill_kv_pages_live`` counts the pages of those blocks,
    as the kernel's span plan walks them (bf16 pages keep 16)."""
    cfg = ModelConfig(name="hd128-g6", family="dense", n_layers=1,
                      d_model=64, n_heads=6, n_kv_heads=1, head_dim=128,
                      d_ff=64, vocab=64)
    params = init_params(cfg, 0, device="cpu")
    eng = ServeEngine(cfg, params, slots=1, max_len=64, page_size=16,
                      cache_dtype=dtype, device="cpu")
    want_blk = 8 if dtype == torch.float32 else 16
    assert eng.q_block == want_blk
    n = 40
    assert eng.chunk >= n                       # one chunk
    prompt = np.arange(2, 2 + n, dtype=np.int32)
    eng.run([Request(uid=0, prompt=prompt, max_new_tokens=2)])
    plan = span_plan([0], [n], n, 16, 64, q_block=eng.q_block)
    walked = sum(p1 - p0 for spans in plan[0] for p0, p1 in spans)
    assert eng.stats.prefill_kv_pages_live == walked
    assert walked == chunk_pages_streamed(0, n, page=16,
                                          q_block=want_blk)
    assert (walked > chunk_pages_streamed(0, n, page=16)) \
        == (want_blk < Q_BLOCK)
