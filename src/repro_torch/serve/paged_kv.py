"""Paged KV-cache pool: block-table paging over one shared device arena
(counterpart of ``repro.serve.paged_kv``; the host logic is a copy).

Every sequence draws fixed-size pages from a single ``[n_pages, page,
kv_dim]`` arena per layer group, addressed through a per-sequence block
table. Page 0 is the null page for inactive lanes and padding. Pages are
reference counted; double frees and frees of still-referenced pages raise.
Page sharing (the prefix cache's ``adopt``/``retain``/``cow``) and
``trim`` are not ported yet.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.memsys.workload import pages_for  # noqa: F401
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
                 cache_dtype=torch.float32, device="cpu"):
        if page & (page - 1):
            raise ValueError(f"page size must be a power of 2, got {page}")
        self.cfg = cfg
        self.page = page
        self.n_pages = n_pages
        self.max_slots = max_slots
        self.max_pages_per_seq = max_pages_per_seq
        self.cache_dtype = cache_dtype
        self.device = device
        self.free: deque = deque(range(1, n_pages + 1))
        self._free_set = set(self.free)
        self.ref = np.zeros(n_pages + 1, np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self.block_tables = np.zeros((max_slots, max_pages_per_seq),
                                     np.int32)
        self.pages_peak = 0
        # set on every block-table mutation, cleared once the tables are
        # uploaded (pure decode rounds skip the upload)
        self.tables_dirty = True

    @property
    def free_count(self) -> int:
        return len(self.free)

    @property
    def used_count(self) -> int:
        return self.n_pages - len(self.free)

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

    def free_slot(self, slot: int) -> int:
        """Drop the slot's references; returns how many pages were
        recycled."""
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
