"""The port's prefix cache, its pool sharing half and in-flight dedup
(``repro_torch.serve.prefix_cache``, ``paged_kv``, ``scheduler``,
``engine``) against the JAX package's, on the CPU.

The radix and pool cases of ``tests/test_prefix_cache.py`` run on the
port's pool and index; a seeded random sequence of admit / finish /
evict / COW operations runs on both packages' pools and indexes side by
side and must hand out the same page ids and keep the same refcounts;
and the engine with ``prefix_cache=True`` on ``tests/conftest.py:
SERVE_BASE`` (fp32 and int8 KV) must give the JAX engine's tokens
(``weight_plan=False``) and the same cache, dedup, COW, eviction and
page-op stats, across runs that persist the cache and under pressure
that evicts and preempts."""
import numpy as np
import pytest

from repro.models.config import ModelConfig as JaxModelConfig
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.paged_kv import PagedKVPool as JaxPool
from repro.serve.prefix_cache import PrefixCache as JaxCache
from repro_torch.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged_kv import PageAccountingError, PagedKVPool
from repro_torch.serve.prefix_cache import PrefixCache
from test_torch_bridge import jax_tree_to_numpy

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=64)
CFG = ModelConfig(name="t", family="dense", **BASE)
PAGE = 8
STATS = ("tokens_out", "rounds", "prefills", "prefill_chunks",
         "prompt_tokens", "prefill_tokens", "prefill_tokens_padded",
         "cache_hits", "cache_hit_tokens", "dedup_hits", "cow_copies",
         "cache_evictions", "adopt_calls", "page_copy_calls",
         "device_tables_rebuilds", "page_op_flushes", "page_ops_batched",
         "preemptions", "tokens_discarded", "solo_rounds", "pages_peak")


def _pool(n_pages=16, max_slots=4, max_pages=8):
    return PagedKVPool(CFG, n_pages=n_pages, page=PAGE, max_slots=max_slots,
                       max_pages_per_seq=max_pages, device="cpu")


def _prompt(rng, n):
    return rng.integers(2, CFG.vocab, n).astype(np.int32)


# ---------------------------------------------------------------------------
# the radix index and the pool (the cases of tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------
def test_radix_hit_miss_partial():
    pool = _pool()
    cache = PrefixCache(pool)
    prompt = _prompt(np.random.default_rng(0), 3 * PAGE + 3)
    assert cache.match(prompt) == ([], 0)            # cold miss
    pages = pool.ensure(0, len(prompt))
    cache.insert(prompt, pages[:3])
    assert len(cache) == 3
    got, n = cache.match(prompt)
    assert n == 3 * PAGE and got == pages[:3]
    other = prompt.copy()
    other[PAGE + 1] ^= 1                             # diverges in page 1
    assert cache.match(other) == (pages[:1], PAGE)
    third = prompt.copy()
    third[0] ^= 1                                    # diverges in page 0
    assert cache.match(third) == ([], 0)
    assert cache.match(prompt[:PAGE - 1]) == ([], 0)


def test_radix_match_covers_whole_prompt_only_in_full_pages():
    pool = _pool()
    cache = PrefixCache(pool)
    prompt = np.arange(2, 2 + 2 * PAGE, dtype=np.int32)
    cache.insert(prompt, pool.ensure(0, len(prompt)))
    got, n = cache.match(prompt)
    assert n == len(prompt) and len(got) == 2
    got, n = cache.match(prompt[:2 * PAGE - 1])
    assert n == PAGE and len(got) == 1


def test_radix_insert_existing_block_keeps_first_page():
    pool = _pool()
    cache = PrefixCache(pool)
    prompt = np.arange(2, 2 + PAGE, dtype=np.int32)
    first = pool.ensure(0, PAGE)
    cache.insert(prompt, first)
    dup = pool.ensure(1, PAGE)
    assert cache.insert(prompt, dup) == 0
    assert cache.match(prompt.tolist() + [9])[0] == first
    assert pool.ref[dup[0]] == 1


def test_radix_lru_leaf_first_eviction():
    pool = _pool()
    cache = PrefixCache(pool)
    a = np.arange(0, 3 * PAGE, dtype=np.int32) % 60 + 2
    b = a.copy()
    b[2 * PAGE] ^= 1                                 # shares 2 pages
    pa = pool.ensure(0, len(a))
    cache.insert(a, pa)
    cache.match(a)
    pb_own = pool.ensure(1, PAGE)
    cache.insert(b, pa[:2] + pb_own)
    pool.free_slot(0)
    pool.free_slot(1)
    assert cache.evictable_pages() == 4
    assert cache.evict(1) == 1                       # a's older leaf
    assert cache.match(a)[1] == 2 * PAGE
    assert cache.match(b)[1] == 3 * PAGE
    assert cache.evict(100) == 3
    assert len(cache) == 0 and pool.free_count == pool.n_pages


def test_radix_pinned_pages_not_evictable():
    pool = _pool()
    cache = PrefixCache(pool)
    prompt = np.arange(2, 2 + 2 * PAGE, dtype=np.int32)
    cache.insert(prompt, pool.ensure(0, len(prompt)))
    assert cache.evictable_pages() == 0 and cache.evict(5) == 0
    pool.free_slot(0)
    assert cache.evictable_pages() == 2
    pool.adopt(1, cache.match(prompt)[0])
    assert cache.evictable_pages() == 0 and cache.evict(5) == 0
    assert pool.pinned_count == 2 and pool.cached_only_count == 0


def test_pool_release_refcounts_and_double_free():
    pool = _pool()
    (pid,) = pool.ensure(0, 4)
    pool.retain(pid)
    assert pool.release(pid) is False
    assert pool.release(pid) is True
    with pytest.raises(PageAccountingError):
        pool.release(pid)
    with pytest.raises(PageAccountingError):
        pool.retain(pid)


def test_pool_free_slot_spares_cached_pages():
    pool = _pool()
    pages = pool.ensure(0, 2 * PAGE)
    for pid in pages:
        pool.retain(pid)
    assert pool.free_slot(0) == 0
    assert pool.free_count == pool.n_pages - 2
    for pid in pages:
        assert pool.release(pid)
    assert pool.free_count == pool.n_pages
    assert pool.can_fit(pool.n_pages * PAGE)
    assert not pool.can_fit(pool.n_pages * PAGE + 1)


def test_pool_adopt_requires_live_pages_and_empty_slot():
    pool = _pool()
    pages = pool.ensure(0, PAGE)
    pool.adopt(1, pages)
    assert pool.ref[pages[0]] == 2 and pool.adopt_calls == 1
    with pytest.raises(PageAccountingError):
        pool.adopt(1, pages)                         # non-empty slot
    with pytest.raises(PageAccountingError):
        pool.adopt(2, [pool.free[0]])                # unallocated page
    with pytest.raises(PageAccountingError):
        pool.adopt(3, [0])                           # the null page


def test_pool_cow_semantics():
    pool = _pool(n_pages=3, max_slots=3, max_pages=2)
    pages = pool.ensure(0, 2 * PAGE)
    assert pool.cow(0, 0) is None                    # private: no copy
    pool.adopt(1, pages)
    src, dst = pool.cow(1, 0)
    assert src == pages[0] and pool.slot_pages[1][0] == dst != src
    assert pool.block_tables[1, 0] == dst
    assert pool.ref[src] == 1 and pool.ref[dst] == 1
    assert pool.cow_copies == 1
    pool.adopt(2, [pages[1]])
    assert pool.cow(2, 0) is False                   # caller must evict


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_ops_match_the_jax_pool_and_index(seed):
    """Admit (match, adopt, ensure, COW on whole-prompt hits, publish),
    finish, evict and trim in a seeded random order on both packages: the
    same page ids, refcounts, block tables, free lists and matches."""
    rng = np.random.default_rng(seed)
    page, slots = 4, 3
    jcfg = JaxModelConfig(name="t", family="dense", **BASE)
    pools = (JaxPool(jcfg, n_pages=10, page=page, max_slots=slots,
                     max_pages_per_seq=4),
             PagedKVPool(CFG, n_pages=10, page=page, max_slots=slots,
                         max_pages_per_seq=4, device="cpu"))
    caches = (JaxCache(pools[0]), PrefixCache(pools[1]))
    live = {}
    for _ in range(60):
        op = rng.choice(["admit", "finish", "evict", "trim"])
        results = []
        if op == "admit" and len(live) < slots:
            slot = next(s for s in range(slots) if s not in live)
            prompt = rng.integers(2, 5, int(rng.integers(2, 17))).astype(
                np.int32)
            for pool, cache in zip(pools, caches):
                pages, c = cache.match(prompt)
                start = min(c, len(prompt) - 1)
                pool.adopt(slot, pages)
                if pool.ensure(slot, len(prompt)) is None:
                    pool.free_slot(slot)
                    results.append(None)
                    continue
                cow = pool.cow(slot, start) if pages else None
                if cow is False:
                    pool.free_slot(slot)
                    results.append(False)
                    continue
                cache.insert(prompt, pool.slot_pages[slot][:len(prompt)
                                                           // page])
                results.append((tuple(pages), c, cow))
            if results[1] not in (None, False):
                live[slot] = prompt
        elif op == "finish" and live:
            slot = int(rng.choice(sorted(live)))
            results = [pool.free_slot(slot) for pool in pools]
            del live[slot]
        elif op == "evict":
            n = int(rng.integers(1, 4))
            results = [cache.evict(n) for cache in caches]
        elif op == "trim" and live:
            slot = int(rng.choice(sorted(live)))
            keep = int(rng.integers(0, len(live[slot]) + 1))
            live[slot] = live[slot][:max(keep, 1)]
            results = [pool.trim(slot, keep) for pool in pools]
        if results:
            assert results[0] == results[1], (op, results)
        j, p = pools
        assert (j.ref == p.ref).all()
        assert list(j.free) == list(p.free)
        assert j.slot_pages == p.slot_pages
        assert (j.block_tables == p.block_tables).all()
        assert (j.cow_copies, j.adopt_calls, j.pages_peak) == (
            p.cow_copies, p.adopt_calls, p.pages_peak)
        assert caches[0].version == caches[1].version
        assert sorted(caches[0]._nodes) == sorted(caches[1]._nodes)
        assert (j.pinned_count, j.cached_only_count) == (
            p.pinned_count, p.cached_only_count)
        caches[1].check_invariants()


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines(serve_cfg, serve_params, serve_cfg_int8, serve_params_int8):
    from conftest import SERVE_BASE
    out = {}
    for name, jcfg, jp, quant in (("fp32", serve_cfg, serve_params, False),
                                  ("int8", serve_cfg_int8,
                                   serve_params_int8, True)):
        pcfg = ModelConfig(name=jcfg.name, family="dense",
                           kv_cache_quant=quant, **SERVE_BASE)
        out[name] = ((jcfg, jp), (pcfg, params_from_numpy(
            jax_tree_to_numpy(jp), device="cpu")))
    return out


def _tenants(cls, n=6, sys_len=24, lo=4, hi=12, max_new=5, seed=3):
    """A shared system prompt and a distinct user suffix per request."""
    rng = np.random.default_rng(seed)
    sys_prompt = _prompt(rng, sys_len)
    return [cls(uid=i, prompt=np.concatenate(
        [sys_prompt, _prompt(rng, int(u))]).astype(np.int32),
        max_new_tokens=max_new)
        for i, u in enumerate(rng.integers(lo, hi, size=n))]


def _pair(w, **kw):
    (jcfg, jp), (pcfg, pp) = w
    jeng = JaxEngine(jcfg, jp, page_size=PAGE, weight_plan=False, **kw)
    peng = ServeEngine(pcfg, pp, page_size=PAGE, device="cpu", **kw)
    return jeng, peng


def _run_equal(jeng, peng, make):
    jout = jeng.run(make(JaxRequest))
    pout = peng.run(make(Request))
    assert [r.out_tokens for r in pout] == [r.out_tokens for r in jout]
    assert all(r.done for r in pout)
    for f in STATS:
        assert getattr(peng.stats, f) == getattr(jeng.stats, f), f
    return pout


def _at_rest(eng):
    pool = eng._pool
    pool.check_tables()
    eng.prefix_cache.check_invariants()
    assert pool.pinned_count == 0
    assert pool.used_count == eng.prefix_cache.cached_pages()


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_engine_prefix_cache_equals_jax(engines, kv):
    jeng, peng = _pair(engines[kv], slots=4, max_len=64, prefix_cache=True)
    out = _run_equal(jeng, peng, _tenants)
    s = peng.stats
    assert s.cache_hits >= 5 and s.cache_hit_tokens >= 5 * 24
    assert s.prefill_tokens < s.prompt_tokens
    assert s.hit_rate == jeng.stats.hit_rate
    assert s.prefill_token_reduction == jeng.stats.prefill_token_reduction
    off = ServeEngine(*engines[kv][1], slots=4, max_len=64, page_size=PAGE,
                      device="cpu").run(_tenants(Request))
    assert [r.out_tokens for r in off] == [r.out_tokens for r in out]
    _at_rest(peng)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_engine_cow_and_inflight_dedup_equal_jax(engines, kv):
    """Identical page-aligned prompts: the first copy prefills, the next
    ones alias its pages while it is live (in-flight dedup) or the
    index's once it published, and COW the page the recomputed last
    token lands in."""
    prompt = _prompt(np.random.default_rng(7), 2 * PAGE)

    def make(cls):
        return [cls(uid=i, prompt=prompt.copy(), max_new_tokens=6)
                for i in range(3)]
    for prefix in (True, False):
        jeng, peng = _pair(engines[kv], slots=4, max_len=64,
                           prefix_cache=prefix)
        out = _run_equal(jeng, peng, make)
        s = peng.stats
        assert s.cow_copies == 2 and s.page_copy_calls == 2
        assert s.cache_hits + s.dedup_hits == 2
        if not prefix:
            assert s.dedup_hits == 2
        assert out[0].out_tokens == out[1].out_tokens == out[2].out_tokens


def test_engine_prefix_cache_persists_across_runs(engines):
    jeng, peng = _pair(engines["fp32"], slots=4, max_len=64,
                       prefix_cache=True)
    make = (lambda cls: _tenants(cls, n=4))
    _run_equal(jeng, peng, make)
    first = peng.stats.cache_hits
    out2 = _run_equal(jeng, peng, make)
    assert peng.stats.cache_hits == 4 > first           # run 2: all hit
    off = ServeEngine(*engines["fp32"][1], slots=4, max_len=64,
                      page_size=PAGE, device="cpu").run(make(Request))
    assert [r.out_tokens for r in off] == [r.out_tokens for r in out2]
    _at_rest(peng)


def test_engine_eviction_under_pressure_with_preemption(engines):
    """A pool too small to keep every published page: LRU eviction of
    cached pages and preemption, with the JAX engine's decisions."""
    jeng, peng = _pair(engines["fp32"], slots=2, max_len=48, n_pages=10,
                       prefix_cache=True)
    _run_equal(jeng, peng, lambda cls: _tenants(
        cls, n=8, sys_len=16, lo=6, hi=12, max_new=10, seed=9))
    s = peng.stats
    assert s.cache_hits >= 1 and s.cache_evictions >= 1
    _at_rest(peng)


def test_engine_refuses_recurrent_stacks_with_the_jax_message():
    hybrid = ModelConfig(name="th", family="hybrid", pattern=("hybrid",),
                         d_state=16, ssm_headdim=32, **BASE)
    for kw in (dict(prefix_cache=True), dict(inflight_dedup=True)):
        with pytest.raises(NotImplementedError, match="page-addressable"):
            ServeEngine(hybrid, {}, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="per-position rollback"):
        ServeEngine(hybrid, {}, speculative_k=2, device="cpu")
