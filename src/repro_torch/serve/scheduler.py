"""Admission + chunk scheduling for the paged continuous-batching engine
(counterpart of ``repro.serve.scheduler`` without prefix-cache matching,
in-flight dedup and speculative verify grants).

  * **FIFO admission** — a request is admitted only when a slot is free
    AND the pool can cover its FIRST prefill chunk (later chunks allocate
    lazily, round by round).
  * **Chunked prefill with a per-round token budget** — each round grants
    at most ``max_prefill_tokens`` prefill tokens across all prefilling
    lanes; the round's first grant is exempt, so a long prompt never
    wedges.
  * **Preemption on pool exhaustion** — the youngest slot admitted after
    the requester is evicted recompute-style and requeued at the head.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional

from repro_torch.memsys.workload import pages_for


def bucket_len(n: int, page: int) -> int:
    """Smallest power of two >= max(n, page) (the default-chunk rule)."""
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


class FifoScheduler:
    """FIFO queue + per-round chunk budget + preemption policy."""

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.queue: Deque = deque()
        self._admit_seq = 0           # monotonically increasing admit stamp
        self.admitted_at: dict = {}   # slot -> admit stamp
        self.preemptions = 0
        self._round_budget = cfg.max_prefill_tokens
        self._round_first = True

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

    def grant_chunk(self, n_remaining: int) -> int:
        """Prefill tokens one lane may run this round (0 = idle a round):
        ``min(chunk, remaining)``, capped by what is left of the round's
        budget except for the round's first grant."""
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

    def grant_decode(self, n_emitted: int, max_new: int, pos: int,
                     max_len: int, lead: int = 0) -> bool:
        """May a decode lane take one more token, ``lead`` tokens ahead of
        its retired state? The pipelined engine grants round N+1 while
        round N's token is in flight (``lead=1``): budget and capacity
        finishes are known in advance, so only an EOS landing in the lag
        computes one extra token (trimmed with ``PagedKVPool.trim``).
        ``lead=0`` is the synchronous termination test."""
        return n_emitted + lead < max_new and pos + lead < max_len

    def next_admission(self, free_pages: int):
        """Pop the queue head if the pool can hold its first chunk now
        (else None)."""
        if not self.queue:
            return None
        req = self.queue[0]
        first_end = min(len(req.prompt), self.cfg.chunk)
        if pages_for(first_end, self.cfg.page) > free_pages:
            return None
        return self.queue.popleft()

    def on_admit(self, slot: int) -> None:
        self.admitted_at[slot] = self._admit_seq
        self._admit_seq += 1

    def on_finish(self, slot: int) -> None:
        self.admitted_at.pop(slot, None)

    def choose_victim(self, requester: int) -> Optional[int]:
        """Youngest slot admitted strictly AFTER the requester (or None):
        the oldest admitted slot is never preempted, so it always runs to
        completion and global progress is guaranteed. Ties on the stamp
        fall to the higher slot id."""
        stamp_r = self.admitted_at[requester]
        candidates = [(stamp, slot) for slot, stamp in
                      self.admitted_at.items() if stamp > stamp_r]
        if not candidates:
            return None
        _, slot = max(candidates)
        return slot

    def on_preempt(self, slot: int) -> None:
        self.preemptions += 1
        self.admitted_at.pop(slot, None)
