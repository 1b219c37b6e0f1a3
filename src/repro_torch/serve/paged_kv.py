"""Paged KV-cache pool: block-table paging over one shared device arena
(counterpart of ``repro.serve.paged_kv``; the host logic is a copy).

Every sequence draws fixed-size pages from a single ``[n_pages, page,
kv_dim]`` arena per layer group, addressed through a per-sequence block
table. Page 0 is the null page for inactive lanes and padding. Pages are
reference counted so the prefix cache (``serve/prefix_cache.py``) can
alias one physical page into many block tables: a page's refcount is the
number of slot mappings plus one if the prefix-cache index holds it. A
shared page (refcount > 1) is never written: the first divergent write
goes through :meth:`PagedKVPool.cow`, which hands the slot a private copy
and decrements the shared count (the device copy is the engine's, in its
round's page-ops flush). Double frees and frees of still-referenced pages
raise. ``trim`` rolls a slot back to fewer tokens (a rejected speculative
draft, the pipelined engine's EOS lag).
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.memsys.workload import pages_for
from repro_torch.models import kvcache as KV
from repro_torch.models.config import ModelConfig


class PoolExhausted(Exception):
    """Raised when an allocation cannot be satisfied even after preemption."""


class PageAccountingError(AssertionError):
    """Refcount / free-list invariant violation (a COW or lifetime bug)."""


class PagedKVPool:
    """Free-list page allocator + per-slot block tables + page refcounts.

    Host-side bookkeeping; the arena tensors are owned by the engine.
    ``n_pages`` counts usable pages; the arena adds the null page (id 0).
    """

    def __init__(self, cfg: ModelConfig, *, n_pages: int, page: int,
                 max_slots: int, max_pages_per_seq: int,
                 cache_dtype=torch.float32, device="cuda"):
        if page & (page - 1):
            raise ValueError(f"page size must be a power of 2, got {page}")
        self.cfg = cfg
        self.page = page
        self.n_pages = n_pages
        self.max_slots = max_slots
        self.max_pages_per_seq = max_pages_per_seq
        self.cache_dtype = cache_dtype
        self.device = resolve_device(device)
        self.free: deque = deque(range(1, n_pages + 1))
        self._free_set = set(self.free)
        self.ref = np.zeros(n_pages + 1, np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self.block_tables = np.zeros((max_slots, max_pages_per_seq),
                                     np.int32)
        self.pages_peak = 0
        self.cow_copies = 0
        # page-op counters over the pool's life (the engine takes their
        # differences per run): page adoptions (block-table rewrites for
        # cached or deduplicated pages) and block-table uploads
        self.adopt_calls = 0
        self.tables_rebuilds = 0
        # set on every block-table mutation, cleared once the tables are
        # uploaded (pure decode rounds skip the upload)
        self.tables_dirty = True

    @property
    def free_count(self) -> int:
        return len(self.free)

    @property
    def used_count(self) -> int:
        return self.n_pages - len(self.free)

    @property
    def pinned_count(self) -> int:
        """Pages mapped by at least one live slot (never evictable)."""
        return len({p for pages in self.slot_pages for p in pages})

    @property
    def cached_only_count(self) -> int:
        """Pages held only by the prefix-cache index (evictable)."""
        return self.used_count - self.pinned_count

    def can_fit(self, n_tokens: int) -> bool:
        return pages_for(n_tokens, self.page) <= len(self.free)

    def _pop_free(self) -> int:
        pid = self.free.popleft()
        self._free_set.discard(pid)
        if self.ref[pid] != 0:
            raise PageAccountingError(
                f"page {pid} on the free list with refcount "
                f"{self.ref[pid]}")
        self.ref[pid] = 1
        return pid

    def release(self, pid: int) -> bool:
        """Drop one reference to pid; recycle it when the count hits 0."""
        if pid in self._free_set:
            raise PageAccountingError(f"double free of page {pid}")
        if self.ref[pid] <= 0:
            raise PageAccountingError(
                f"release of page {pid} with refcount {self.ref[pid]}")
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self.free.append(pid)
            self._free_set.add(pid)
            return True
        return False

    def retain(self, pid: int) -> None:
        """Add a reference (the prefix cache publishing a page)."""
        if pid in self._free_set or self.ref[pid] <= 0:
            raise PageAccountingError(
                f"retain of unallocated page {pid}")
        self.ref[pid] += 1

    def ensure(self, slot: int, n_tokens: int) -> Optional[List[int]]:
        """Grow slot's allocation to cover n_tokens positions. Returns the
        newly allocated page ids, or None if the free list cannot satisfy
        the request (the caller decides whom to preempt)."""
        have = len(self.slot_pages[slot])
        need = pages_for(n_tokens, self.page)
        if need > self.max_pages_per_seq:
            raise PoolExhausted(
                f"sequence needs {need} pages > max_pages_per_seq="
                f"{self.max_pages_per_seq}")
        if need <= have:
            return []
        if need - have > len(self.free):
            return None
        fresh = [self._pop_free() for _ in range(need - have)]
        self.tables_dirty = True
        for j, pid in enumerate(fresh, start=have):
            self.slot_pages[slot].append(pid)
            self.block_tables[slot, j] = pid
        self.pages_peak = max(self.pages_peak, self.used_count)
        return fresh

    def adopt(self, slot: int, page_ids: List[int]) -> None:
        """Map already-live (cache-held) pages into an empty slot's table.
        The slot shares them read-only: each gains a reference, and a
        later write into one must go through :meth:`cow` first."""
        if self.slot_pages[slot]:
            raise PageAccountingError(
                f"adopt into non-empty slot {slot}")
        self.adopt_calls += 1
        self.tables_dirty = True
        for j, pid in enumerate(page_ids):
            if pid == 0:
                raise PageAccountingError(
                    "adopt of the reserved null page 0 (would alias every "
                    "inactive lane's scratch page into a live table)")
            self.retain(pid)
            self.slot_pages[slot].append(pid)
            self.block_tables[slot, j] = pid
        self.pages_peak = max(self.pages_peak, self.used_count)

    def cow(self, slot: int, token_pos: int):
        """Make the page holding ``token_pos`` private to ``slot``.

        Returns None when the page is already private (refcount 1),
        ``(src, dst)`` when a fresh page ``dst`` was mapped in place of the
        shared ``src`` (the caller copies the device page), or False when
        the free list is empty (the caller evicts or preempts and
        retries). The shared page's refcount drops; it is never written."""
        j = token_pos // self.page
        pid = self.slot_pages[slot][j]
        if self.ref[pid] == 1:
            return None
        if not self.free:
            return False
        dst = self._pop_free()
        self.tables_dirty = True
        self.slot_pages[slot][j] = dst
        self.block_tables[slot, j] = dst
        self.ref[pid] -= 1          # the shared copy stays live elsewhere
        self.cow_copies += 1
        self.pages_peak = max(self.pages_peak, self.used_count)
        return pid, dst

    def trim(self, slot: int, n_tokens: int) -> int:
        """Shrink the slot's allocation back to what ``n_tokens`` positions
        need; returns how many pages were recycled.

        The speculative rollback and the pipelined engine's EOS-lag
        rollback, the same move: a verify step allocated pages out to the
        full draft (a pipelined round, for one token past an EOS that
        retired during the lag), and the tail pages hold only K/V that
        ``valid_len`` masks. They were allocated fresh for positions past
        the live prefix, so they are never shared; release still goes
        through the refcount."""
        keep = pages_for(n_tokens, self.page)
        n = 0
        while len(self.slot_pages[slot]) > keep:
            pid = self.slot_pages[slot].pop()
            self.block_tables[slot, len(self.slot_pages[slot])] = 0
            self.tables_dirty = True
            n += bool(self.release(pid))
        return n

    def free_slot(self, slot: int) -> int:
        """Drop the slot's references; returns how many pages were
        recycled (pages the prefix cache still holds stay allocated)."""
        n = 0
        for pid in self.slot_pages[slot]:
            n += bool(self.release(pid))
        self.slot_pages[slot] = []
        self.block_tables[slot, :] = 0
        self.tables_dirty = True
        return n

    def init_arena(self) -> dict:
        """Fresh zeroed arena (leading n_groups dim, +1 null page)."""
        return KV.paged_init_cache(self.cfg, self.n_pages + 1, self.page,
                                   self.max_slots, self.max_pages_per_seq,
                                   self.cache_dtype, self.device)

    def device_tables(self) -> torch.Tensor:
        """The host block tables as a tensor on the arena's device."""
        return torch.as_tensor(self.block_tables).to(self.device)

    def check_tables(self) -> None:
        """Null-page aliasing guard: page 0 never appears in a live region
        of a block table, and every live region mirrors ``slot_pages``."""
        for s, pages in enumerate(self.slot_pages):
            n = len(pages)
            live = self.block_tables[s, :n]
            if (live == 0).any() or live.tolist() != pages:
                raise PageAccountingError(
                    f"slot {s} block table {self.block_tables[s].tolist()} "
                    f"diverged from its page map {pages}")
            if self.block_tables[s, n:].any():
                raise PageAccountingError(
                    f"slot {s} maps pages beyond its {n} live entries: "
                    f"{self.block_tables[s].tolist()}")
