"""Admission + chunk scheduling for the paged continuous-batching engine
(counterpart of ``repro.serve.scheduler``; the host logic is a copy).

  * **FIFO admission** — a request is admitted only when a slot is free
    AND the pool can cover its FIRST prefill chunk beyond the pages it
    adopts (later chunks allocate lazily, round by round). With a prefix
    cache, admission matches the head's prompt against the radix index
    and chunked prefill starts at the uncached suffix; one index miss is
    in flight at a time, so the requests behind it that share its prefix
    admit as hits once it publishes.
  * **In-flight dedup** — a prompt identical to one a live slot is
    prefilling aliases that slot's full prompt pages (or waits a round
    while the leader is mid-prompt).
  * **Chunked prefill with a per-round token budget** — each round grants
    at most ``max_prefill_tokens`` prefill tokens across all prefilling
    lanes; the round's first grant is exempt, so a long prompt never
    wedges. Speculative verify columns draw on the same budget with no
    exemption (``grant_verify``).
  * **Preemption on pool exhaustion** — the youngest slot admitted after
    the requester is evicted recompute-style and requeued at the head.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.memsys.workload import pages_for
from repro_torch.obs import trace as obs_trace


def bucket_len(n: int, page: int) -> int:
    """Smallest power of two >= max(n, page).

    ``page`` is itself a power of two, so every bucket is a whole number
    of pages. Chunked prefill killed the per-prompt pow2 bucketing; this
    survives as the default-chunk rule (one chunk covers the longest
    admissible prompt unless the caller opts into smaller chunks)."""
    b = page
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class SchedulerConfig:
    page: int = 16
    max_prefill_tokens: int = 512     # prefill tokens granted per round
    max_len: int = 256                # per-sequence logical capacity
    chunk: int = 64                   # prefill chunk width (tokens)


@dataclasses.dataclass
class Admission:
    """One admitted request plus its prefix-cache split.

    ``cached_pages`` alias the index's pages for the first ``cached_len``
    prompt tokens (whole pages; empty on a miss). ``suffix_start`` is where
    chunked prefill must actually run from — ``cached_len``, except for a
    whole-prompt hit where it is ``len(prompt) - 1`` so the final token's
    logit is recomputed (its KV write COWs the shared page it lands in).
    ``dedup`` marks an in-flight dedup: the pages alias a *live slot's*
    prompt pages (an identical prompt admitted earlier in this run) rather
    than the radix index's."""
    req: object
    cached_pages: List[int] = dataclasses.field(default_factory=list)
    cached_len: int = 0
    dedup: bool = False

    @property
    def suffix_start(self) -> int:
        return min(self.cached_len, len(self.req.prompt) - 1)


class FifoScheduler:
    """FIFO queue + per-round chunk budget + preemption policy.

    With a ``prefix_cache``, admission matches the head request's prompt
    against the radix index and hands the engine an :class:`Admission`
    split — chunked prefill then starts at the uncached suffix, and the
    pool-capacity check covers only the first chunk beyond the adopted
    pages.

    **In-flight dedup** (``pool`` given): a *pending-prefill table* maps
    each prompt currently occupying a slot to that leader slot. When the
    queue head's prompt is identical to a pending one, admission aliases
    the leader's full-page prompt prefix into the follower's block table
    (the same adopt→COW→chunked-suffix path a radix hit takes) instead of
    prefilling it again — identical prompts share KV even when the
    prefix-cache index is disabled, or before the leader's pages are
    published to it. Chunked prefill rebases the flow onto chunk
    boundaries: while the leader is still mid-prompt its trailing pages
    are only partially written, so the head *waits* (admission returns
    None) until the leader's prefill completes — ``note_progress`` is the
    engine's per-chunk progress feed. Entries drop when the leader
    finishes or is preempted; the radix index takes over afterwards.

    ``tracer`` (else the process default, ``obs.trace``) receives
    ``sched/admit`` / ``sched/preempt`` instants and the two admission
    stall events — ``sched/dedup_wait`` (head waiting for an in-flight
    identical prompt) and ``sched/miss_wait`` (head serialized behind
    the one open prefix-cache miss) — so queueing decisions are visible
    on the trace timeline, not just in aggregate counters."""

    def __init__(self, cfg: SchedulerConfig, prefix_cache=None, pool=None,
                 tracer=None):
        self.cfg = cfg
        self.prefix_cache = prefix_cache
        self.pool = pool              # enables in-flight dedup
        self._tracer = tracer
        self.queue: Deque = deque()
        self._admit_seq = 0           # monotonically increasing admit stamp
        self.admitted_at: dict = {}   # slot -> admit stamp
        self.preemptions = 0
        self._round_budget = cfg.max_prefill_tokens
        self._round_first = True
        self.pending_prefill: Dict[bytes, int] = {}   # prompt key -> slot
        self._slot_keys: Dict[int, bytes] = {}
        self.filled: Dict[int, int] = {}  # slot -> prompt tokens in KV
        self._open_miss: set = set()  # slots mid-prefill of index misses
        self._match_memo = None   # (req id, index version, pages, len)

    def enqueue(self, req) -> None:
        self.queue.append(req)

    def requeue_front(self, req) -> None:
        """Preempted request goes back to the queue head (FIFO fairness)."""
        self.queue.appendleft(req)

    @property
    def pending(self) -> int:
        return len(self.queue)

    def start_round(self) -> None:
        self._round_budget = self.cfg.max_prefill_tokens
        self._round_first = True

    # ---- per-round chunk budget ----------------------------------------
    def grant_chunk(self, n_remaining: int) -> int:
        """Prefill tokens one lane may run this round (0 = idle a round).

        Grants are ``min(chunk, remaining)``, capped by what is left of
        this round's ``max_prefill_tokens``. The round's FIRST grant
        ignores the cap — the budget throttles prefill *bursts* relative
        to decode lanes, it must never wedge a chunk wider than the
        budget. Invariant (pinned by tests): after the first grant, the
        sum of a round's grants never exceeds ``max_prefill_tokens``."""
        want = min(self.cfg.chunk, int(n_remaining))
        if want <= 0:
            return 0
        if self._round_first:
            self._round_first = False
            self._round_budget -= want
            return want
        n = min(want, self._round_budget)
        if n <= 0:
            return 0
        self._round_budget -= n
        return n

    def grant_verify(self, n_draft: int) -> int:
        """Draft tokens a decode lane may verify this round (speculative
        decode), drawn from the SAME per-round ``max_prefill_tokens``
        budget as chunk grants: verify columns are extra step width
        exactly like prefill tokens, so they must not starve prefill
        lanes the budget was sized for. Unlike :meth:`grant_chunk` there
        is no first-grant exemption — drafts are optional work; a lane
        that gets 0 here simply decodes one token as usual (the carried
        token is never charged)."""
        n = min(int(n_draft), self._round_budget)
        if n <= 0:
            return 0
        self._round_budget -= n
        return n

    def grant_decode(self, n_emitted: int, max_new: int, pos: int,
                     max_len: int, lead: int = 0) -> bool:
        """May a decode lane take one more token, ``lead`` tokens ahead
        of its retired state? The pipelined engine grants round N+1
        while round N's token is still in flight (``lead=1``): budget
        (``max_new_tokens``) and capacity (``max_len``) finishes are
        deterministic, so counting the in-flight token here means those
        lanes are never overrun — only an EOS landing during the lag
        computes one extra token, trimmed via ``PagedKVPool.trim``
        exactly like a rejected speculative draft. ``lead=0`` is the
        synchronous engine's termination test, pre-emit."""
        return n_emitted + lead < max_new and pos + lead < max_len

    def next_admission(self, free_pages: int) -> Optional[Admission]:
        """Pop the queue head if a slot's first chunk can start now.

        Returns an :class:`Admission` (request + prefix-cache split), or
        None (empty queue / pool cannot hold the first chunk beyond the
        adopted prefix / the head must wait for an in-flight identical
        prompt to finish prefilling). ``free_pages`` may include pages
        the engine can evict from the prefix cache on demand. Chunk
        tokens are charged per round via :meth:`grant_chunk`, not here —
        admission is seat-only."""
        if not self.queue:
            return None
        req = self.queue[0]
        adm = Admission(req)
        if self.prefix_cache is not None:
            # memoized per (head request, index version): a head blocked
            # on capacity for several rounds must not charge the index's
            # lookup stats or refresh its LRU stamps once per round
            memo = self._match_memo
            key = (id(req), self.prefix_cache.version)
            if memo is not None and memo[0] == key:
                adm.cached_pages, adm.cached_len = memo[1]
            else:
                adm.cached_pages, adm.cached_len = \
                    self.prefix_cache.match(req.prompt)
                self._match_memo = (key, (adm.cached_pages,
                                          adm.cached_len))
        if self._match_pending(adm):
            obs_trace.active(self._tracer).instant(
                "sched/dedup_wait", uid=getattr(req, "uid", None))
            return None               # wait for the in-flight leader
        if (self.prefix_cache is not None and not adm.cached_pages
                and self._open_miss):
            # one index MISS in flight at a time: a miss's pages publish
            # to the radix when its chunked prefill completes, so the
            # head behind it — which often shares the prefix (the
            # multi-tenant system prompt) — admits as a HIT once the
            # leader finishes instead of re-prefilling the same pages in
            # parallel. Hits admit freely; pre-chunking prefill was
            # fully serial anyway, so this never loses to the old path.
            obs_trace.active(self._tracer).instant(
                "sched/miss_wait", uid=getattr(req, "uid", None))
            return None
        L = len(req.prompt)
        start = adm.suffix_start
        first_end = min(L, start + self.cfg.chunk)
        # fresh pages to cover the first chunk beyond the adopted prefix,
        # plus one for the COW of a whole-prompt hit's recomputed token
        need = (pages_for(first_end, self.cfg.page)
                - len(adm.cached_pages)
                + (1 if adm.cached_len >= L else 0))
        if need > free_pages:
            return None
        self.queue.popleft()
        return adm

    def miss_open(self, slot: int) -> None:
        """A cache-miss admission started chunking in ``slot`` — further
        misses wait until :meth:`miss_closed` (publish gate above). A
        set, not a scalar: a hit that degrades to a miss mid-admission
        can open a second slot while one is already chunking, and the
        gate must hold until the LAST open miss publishes."""
        self._open_miss.add(slot)

    def miss_closed(self, slot: int) -> None:
        """The slot's prefill completed (pages published), finished, or
        was preempted — miss admissions may flow again once no miss is
        left in flight."""
        self._open_miss.discard(slot)

    # ---- in-flight dedup (pending-prefill table) -----------------------
    @staticmethod
    def prompt_key(prompt) -> bytes:
        return np.asarray(prompt, np.int32).tobytes()

    def note_prefill(self, req, slot: int) -> None:
        """Record that ``slot`` holds a live prefill of ``req.prompt`` —
        later identical prompts adopt its full pages instead of
        prefilling. First prompt in wins; the entry lives until the slot
        finishes or is preempted."""
        if self.pool is None:
            return
        key = self.prompt_key(req.prompt)
        if key not in self.pending_prefill:
            self.pending_prefill[key] = slot
            self._slot_keys[slot] = key

    def note_progress(self, slot: int, n_tokens: int) -> None:
        """Engine feed: ``slot`` now holds ``n_tokens`` prompt tokens in
        KV (advanced after every chunk). Gates when a pending-prefill
        leader's pages become aliasable — a page is safe to share only
        once every token in it has been written."""
        self.filled[slot] = int(n_tokens)

    def _drop_pending(self, slot: int) -> None:
        key = self._slot_keys.pop(slot, None)
        if key is not None and self.pending_prefill.get(key) == slot:
            del self.pending_prefill[key]
        self.filled.pop(slot, None)

    def _match_pending(self, adm: Admission) -> bool:
        """Upgrade ``adm`` to alias an in-flight identical prompt's pages
        when that beats the radix match (a slot holds the WHOLE prompt,
        the index at best its published prefix). Returns True when the
        head should WAIT instead: the leader is still mid-prefill, so its
        trailing pages are not fully written yet — one round later they
        will be, and aliasing beats recomputing the whole prompt."""
        if self.pool is None:
            return False
        leader = self.pending_prefill.get(self.prompt_key(adm.req.prompt))
        if leader is None:
            return False
        L = len(adm.req.prompt)
        n_full = L // self.cfg.page
        if adm.cached_len >= n_full * self.cfg.page:
            return False              # radix already covers the max share
        if self.filled.get(leader, 0) < L:
            return True               # leader mid-prefill: wait a round
        pages = self.pool.slot_pages[leader][:n_full]
        if len(pages) == n_full and n_full * self.cfg.page > adm.cached_len:
            adm.cached_pages = list(pages)
            adm.cached_len = n_full * self.cfg.page
            adm.dedup = True
        return False

    def on_admit(self, slot: int) -> None:
        self.admitted_at[slot] = self._admit_seq
        obs_trace.active(self._tracer).instant(
            "sched/admit", slot=slot, stamp=self._admit_seq)
        self._admit_seq += 1

    def on_finish(self, slot: int) -> None:
        self.admitted_at.pop(slot, None)
        self._drop_pending(slot)
        self.miss_closed(slot)

    def choose_victim(self, requester: int) -> Optional[int]:
        """Youngest slot admitted strictly AFTER the requester (or None).

        Only younger slots are evictable: letting a freshly restarted
        (hence younger) sequence evict an older one livelocks — the two
        ping-pong, erasing each other's progress forever. With this order
        the oldest admitted slot is never preempted, so it always runs to
        completion and frees its pages: global progress is guaranteed.
        A requester with no younger victim preempts *itself* and waits.

        The max over (stamp, slot) tuples is a deterministic total order:
        equal stamps (possible when admission records are restored or
        injected out of band) fall through to the higher slot id, never to
        dict iteration order. Pinned by a regression test."""
        stamp_r = self.admitted_at[requester]
        candidates = [(stamp, slot) for slot, stamp in
                      self.admitted_at.items() if stamp > stamp_r]
        if not candidates:
            return None
        _, slot = max(candidates)
        return slot

    def on_preempt(self, slot: int) -> None:
        self.preemptions += 1
        obs_trace.active(self._tracer).instant("sched/preempt", slot=slot)
        self.admitted_at.pop(slot, None)
        self._drop_pending(slot)
        self.miss_closed(slot)
