"""Prefix cache: radix block index + copy-on-write page sharing
(counterpart of ``repro.serve.prefix_cache``; a copy, host-side numpy).

Multi-tenant edge traffic is dominated by shared system prompts and
few-shot preambles. Because the paged pool (``serve/paged_kv.py``) already
addresses KV through per-sequence block tables, a shared prompt prefix can
be served by *aliasing* the same physical pages into many tables — which
removes both the prefill FLOPs for the cached tokens and the page-rounded
LPDDR5 KV writes the memsys DSE charges for them
(``memsys.workload.kv_traffic_prefix``).

Index structure
---------------
A radix tree over **full KV pages**: each edge is keyed by the tuple of
``page`` token ids a page holds, so a node at depth d is the unique page
caching tokens ``[(d-1)*page, d*page)`` of every prompt that shares that
token path. Matching walks the tree block by block and returns the longest
cached page run; insertion publishes a finished prefill's full pages,
creating nodes for blocks not yet present.

Lifetime rules
--------------
The pool's per-page refcount is the single source of truth:

  * publishing a page into the index adds one reference
    (``pool.retain``) — the index keeps the page alive after its
    producing sequence finishes;
  * a match that is adopted into a slot adds one reference per page
    (``pool.adopt``) — adopted pages are *pinned*: they can never be
    evicted or written while any slot maps them;
  * a cached page whose refcount is exactly 1 (index-only) is
    **evictable**; eviction is leaf-first LRU (a node may only be removed
    once all of its children are gone, so every cached path always starts
    at the root) and returns the page to the pool free list;
  * a shared page is **never scattered into**: the first divergent write
    goes through ``pool.cow`` — the writer gets a private copy (the
    device copy is ``serve.steps.apply_page_ops``, in place) and the shared
    refcount drops by one.

Only *full* pages are cached, and a match never covers the final prompt
token (the engine must compute its logit), so at most
``floor((len(prompt) - 1) / page)`` pages can be served from cache; when a
whole page-aligned prompt is cached the engine adopts every page and
re-computes just the last token, COW-privatizing the page it lands in.

The index never touches device memory itself: it stores page *ids*; all
device copies happen in the engine, in its round's page-ops flush.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.serve.paged_kv import PagedKVPool


class _Node:
    """One cached page. ``key`` is the page's token-id tuple under its
    parent; ``stamp`` is the LRU clock value of the last touch."""

    __slots__ = ("key", "page_id", "children", "parent", "stamp")

    def __init__(self, key: Optional[Tuple[int, ...]], page_id: int,
                 parent: Optional["_Node"], stamp: int):
        self.key = key
        self.page_id = page_id
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.stamp = stamp


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0                 # lookups that matched >= 1 page
    hit_tokens: int = 0           # tokens served from cache across lookups
    lookup_tokens: int = 0        # prompt tokens across lookups
    published_pages: int = 0      # new pages inserted into the index
    evicted_pages: int = 0

    @property
    def hit_rate(self) -> float:
        """Token hit rate: fraction of looked-up prompt tokens served from
        cached pages."""
        return (self.hit_tokens / self.lookup_tokens
                if self.lookup_tokens else 0.0)


class PrefixCache:
    """Radix index of cached full KV pages over a :class:`PagedKVPool`.

    Host-side only; see the module docstring for lifetime rules.

    ``tracer`` (else the process default, ``obs.trace``) receives
    ``cache/published`` and ``cache/evicted`` instants — each marks a
    host-side index mutation whose pages a slot must later adopt or
    re-prefill, i.e. a page-op round trip in the making."""

    def __init__(self, pool: PagedKVPool, tracer=None):
        self.pool = pool
        self._tracer = tracer
        self.page = pool.page
        self.root = _Node(None, 0, None, 0)
        self._clock = 0
        self._nodes: Dict[int, _Node] = {}      # page_id -> node
        self.stats = PrefixCacheStats()
        self.version = 0      # bumped on insert/evict: match memo key

    # ---- introspection -------------------------------------------------
    def __len__(self) -> int:
        return len(self._nodes)

    def cached_pages(self) -> int:
        return len(self._nodes)

    def evictable_pages(self) -> int:
        """Cached pages no live slot maps (refcount 1 = index only).

        Eviction is leaf-first, but any index-only page is reachable by
        repeated leaf eviction: a slot pinning a descendant pins nothing
        above it only in the tree sense — refcounts are per page — so every
        refcount-1 page is eventually evictable and may be promised to the
        admission capacity check."""
        return sum(1 for pid in self._nodes if self.pool.ref[pid] == 1)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ---- lookup --------------------------------------------------------
    def match(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Longest cached full-page prefix of ``tokens``.

        Returns (page_ids, n_cached_tokens) over *complete* pages only, so
        n_cached <= floor(len / page) * page. A match may cover the whole
        prompt (page-aligned repeat); the engine then recomputes just the
        final token, COW-privatizing the page its write lands in, because
        the last token's logit is never cached. Touches every matched
        node's LRU stamp."""
        toks = [int(t) for t in tokens]
        self.stats.lookups += 1
        self.stats.lookup_tokens += len(toks)
        node, pages = self.root, []
        stamp = self._tick()
        while (len(pages) + 1) * self.page <= len(toks):
            key = tuple(toks[len(pages) * self.page:
                             (len(pages) + 1) * self.page])
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = stamp
            node = child
            pages.append(child.page_id)
        if pages:
            self.stats.hits += 1
            self.stats.hit_tokens += len(pages) * self.page
        return pages, len(pages) * self.page

    # ---- publish -------------------------------------------------------
    def insert(self, tokens: np.ndarray, page_ids: List[int]) -> int:
        """Publish a prefilled prompt's full pages; returns #new entries.

        ``page_ids`` are the producing slot's pages, in token order; only
        the ``len(tokens) // page`` complete pages are indexed. A block
        already present keeps its existing page (concurrent duplicate
        prefills are not deduplicated retroactively — the newcomer's page
        simply stays private to its slot). Newly indexed pages gain one
        pool reference so they outlive the producing sequence."""
        toks = [int(t) for t in tokens]
        n_full = min(len(toks) // self.page, len(page_ids))
        node, new = self.root, 0
        stamp = self._tick()
        for j in range(n_full):
            key = tuple(toks[j * self.page:(j + 1) * self.page])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, page_ids[j], node, stamp)
                node.children[key] = child
                self._nodes[page_ids[j]] = child
                self.pool.retain(page_ids[j])
                new += 1
            else:
                child.stamp = stamp
            node = child
        self.stats.published_pages += new
        if new:
            self.version += 1
            obs_trace.active(self._tracer).instant(
                "cache/published", pages=new,
                cached_total=len(self._nodes))
        return new

    # ---- eviction ------------------------------------------------------
    def _evictable_leaves(self) -> List[_Node]:
        return [n for n in self._nodes.values()
                if not n.children and self.pool.ref[n.page_id] == 1]

    def evict(self, n_pages: int) -> int:
        """Free >= n_pages unreferenced cached pages if possible (LRU,
        leaf-first); returns how many were actually freed."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            # oldest-stamp first; pop as many distinct leaves as the
            # deficit allows before recomputing (children removals can
            # surface newly-evictable parents)
            for node in sorted(leaves, key=lambda n: n.stamp):
                if freed >= n_pages:
                    break
                self._remove(node)
                freed += 1
        self.stats.evicted_pages += freed
        if freed:
            obs_trace.active(self._tracer).instant(
                "cache/evicted", pages=freed,
                cached_total=len(self._nodes))
        return freed

    def _remove(self, node: _Node) -> None:
        assert not node.children
        del node.parent.children[node.key]
        del self._nodes[node.page_id]
        self.pool.release(node.page_id)
        self.version += 1

    def clear(self) -> int:
        """Evict everything evictable (e.g. before resizing the pool)."""
        return self.evict(len(self._nodes))

    # ---- invariant checking (used by the hypothesis tests) -------------
    def check_invariants(self) -> None:
        """Raise if index/pool bookkeeping has drifted."""
        for pid, node in self._nodes.items():
            assert node.page_id == pid
            assert pid not in self.pool._free_set, f"cached page {pid} free"
            assert self.pool.ref[pid] >= 1, f"cached page {pid} unref'd"
            assert node.parent.children.get(node.key) is node
        # every node is reachable from the root (paths never dangle)
        seen = set()
        stack = [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                seen.add(c.page_id)
                stack.append(c)
        assert seen == set(self._nodes)
