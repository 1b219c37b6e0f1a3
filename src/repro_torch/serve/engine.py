"""Synchronous paged continuous-batching engine (counterpart of
``repro.serve.engine.ServeEngine``'s synchronous loop).

Every round, all active slots run in ONE ragged step against a shared
paged KV arena: decode lanes carry one token each, prefilling lanes a
chunk of their prompt, both in the same call (``serve/steps.py``), with
FIFO admission, a per-round chunk budget and recompute-style preemption
(``serve/scheduler.py``). Each round runs at the smallest width of the
pow2 ladder (``steps.width_ladder``) that covers its widest grant, C = 1
for pure decode, and uploads changed block tables in one page-ops flush
before the step.

Weights may be dense or QMC streams. With ``weight_plan=False`` (the
default) stream leaves go through the qmm kernels; ``weight_plan=True``
dequantizes them once at construction and the step multiplies dense
weights. ``paged_attention=True`` (the default) attends through the
ragged paged-attention kernel. On ``device="cpu"`` every kernel wrapper
runs its plain PyTorch version.

Under greedy decoding the engine is token-identical to the JAX engine on
the same weights: the same admission, chunking and preemption decisions,
and causal attention makes each query independent of how its prompt was
chunked. Not ported yet: the pipelined loop, speculative decode, the
prefix cache and in-flight dedup, the solo-lane step, sampled lanes, and
the obs tracer and metrics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.qtensor import QTensor
from repro_torch.core.serving_quant import build_exec_weights
from repro_torch.memsys.workload import chunk_pages_streamed, pages_for
from repro_torch.models.config import ModelConfig
from repro_torch.serve import sampling as samplib
from repro_torch.serve import steps as serve_steps
from repro_torch.serve.paged_kv import PagedKVPool, PoolExhausted
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import (FifoScheduler, SchedulerConfig,
                                         bucket_len)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    sampling: Optional[SamplingParams] = None
    out_logprobs: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EngineStats:
    prefills: int = 0                # prompts fully prefilled
    prefill_chunks: int = 0          # chunk executions (>= prefills)
    decode_steps: int = 0            # rounds that advanced a decode lane
    tokens_out: int = 0
    wall_s: float = 0.0
    rounds: int = 0                  # engine rounds that ran a step
    preemptions: int = 0
    pages_peak: int = 0
    tokens_discarded: int = 0        # emitted then erased by preemption
    prompt_tokens: int = 0
    prefill_tokens: int = 0
    prefill_tokens_padded: int = 0
    # K/V pages the paged-attention kernel streams (decode lanes; prefill
    # chunks per q block, memsys.workload.chunk_pages_streamed) vs the
    # full block-table width the gather route reads
    kv_pages_live: int = 0
    kv_pages_full: int = 0
    prefill_kv_pages_live: int = 0
    page_op_flushes: int = 0
    # per round: wall seconds and tokens emitted; per request: seconds
    # from run() start to its first token
    step_seconds: List[float] = dataclasses.field(default_factory=list)
    step_tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s else 0.0


def _finished(req: Request, pos: int, max_len: int) -> bool:
    """Budget spent, EOS emitted, or the cache is full (pos == max_len)."""
    return (len(req.out_tokens) >= req.max_new_tokens
            or (req.eos_id is not None and req.out_tokens
                and req.out_tokens[-1] == req.eos_id)
            or pos >= max_len)


def tree_to(tree, device):
    """Move a parameter tree (dicts, tensors, QTensors, per-group QTensor
    lists) to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, (torch.Tensor, QTensor)):
        return tree.to(device)
    return tree


class ServeEngine:
    """Continuous batching over a paged KV pool (see the module
    docstring). ``slots`` bounds concurrent sequences; ``max_len`` is each
    sequence's capacity (prompt + generated); ``n_pages`` sizes the pool
    (default: every slot at full length)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, cache_dtype=torch.float32,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 max_prefill_tokens: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 paged_attention: bool = True, weight_plan: bool = False,
                 sampling: Optional[SamplingParams] = None,
                 device="cuda"):
        if cfg.is_encdec or cfg.n_vis_tokens:
            raise NotImplementedError(
                "the paged engine covers decoder-only models")
        if not all(k.startswith("attn") for k in cfg.pattern):
            raise NotImplementedError(
                f"only attention stacks are ported (pattern={cfg.pattern})")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_to(params, self.device)
        self.slots = slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.page = page_size
        self.max_pages_per_seq = pages_for(max_len, page_size)
        self.n_pages = n_pages or serve_steps.default_n_pages(
            slots, self.max_pages_per_seq)
        self.max_prefill_tokens = (max_prefill_tokens
                                   or max(512, bucket_len(max_len,
                                                          page_size)))
        self.chunk = chunk_tokens or serve_steps.default_chunk(
            self.max_pages_per_seq, page_size)
        self._widths = serve_steps.width_ladder(self.chunk)
        self.paged_attention = paged_attention
        self.stats = EngineStats()
        self._default_sp = sampling or samplib.GREEDY
        self._slot_sp: List[SamplingParams] = [samplib.GREEDY] * slots
        # the serving weight plan: streams dequantized once, at setup
        self._exec_params = (build_exec_weights(self.params) if weight_plan
                             else self.params)
        self._pool: Optional[PagedKVPool] = None
        self._arena = None

    def _ensure_pool(self) -> PagedKVPool:
        if self._pool is None:
            self._pool = PagedKVPool(
                self.cfg, n_pages=self.n_pages, page=self.page,
                max_slots=self.slots,
                max_pages_per_seq=self.max_pages_per_seq,
                cache_dtype=self.cache_dtype, device=self.device)
            self._arena = self._pool.init_arena()
        return self._pool

    def _flush_page_ops(self, pool: PagedKVPool) -> None:
        """Upload the block tables in one page-ops call when they changed;
        pure decode rounds with clean tables skip it."""
        if not pool.tables_dirty:
            return
        pool.check_tables()
        serve_steps.apply_page_ops(self._arena, pool.device_tables())
        pool.tables_dirty = False
        self.stats.page_op_flushes += 1

    def run(self, requests: List[Request]) -> List[Request]:
        """Process all requests to completion; returns them with outputs.

        A generated ``eos_id`` is emitted and generation stops right
        after; a preempted request starts over from its first token.
        Stats describe this run only."""
        self.stats = EngineStats()
        t0 = time.monotonic()
        for r in requests:
            if len(r.prompt) > self.max_len:
                raise ValueError(f"request {r.uid}: prompt length "
                                 f"{len(r.prompt)} > max_len={self.max_len}")
        pool = self._ensure_pool()
        for s in range(self.slots):
            if pool.slot_pages[s]:
                pool.free_slot(s)
        pool.pages_peak = pool.used_count
        sched = FifoScheduler(SchedulerConfig(
            page=self.page, max_prefill_tokens=self.max_prefill_tokens,
            max_len=self.max_len, chunk=self.chunk))
        for r in requests:
            sched.enqueue(r)

        active: List[Optional[Request]] = [None] * self.slots
        pos = np.zeros(self.slots, np.int64)      # next write position
        next_tok = np.zeros(self.slots, np.int64)
        temp = torch.zeros(self.slots, dtype=torch.float32)
        seen_first: set = set()

        def prefilling(s: int) -> bool:
            return (active[s] is not None
                    and pos[s] < len(active[s].prompt))

        def first_token(req: Request) -> None:
            if req.uid not in seen_first:
                seen_first.add(req.uid)
                self.stats.ttft_s.append(time.monotonic() - t0)

        def record(s: int, tok: int, logp: float, req: Request) -> None:
            assert tok != samplib.DEAD_TOKEN, \
                f"emit read a dead lane (slot {s})"
            req.out_tokens.append(tok)
            if self._slot_sp[s].logprobs:
                req.out_logprobs.append(logp)
            self.stats.tokens_out += 1

        def finish(s: int) -> None:
            active[s].done = True
            active[s] = None
            pool.free_slot(s)
            sched.on_finish(s)

        def preempt(victim: int) -> None:
            req = active[victim]
            # recompute-style eviction: drop generated state, requeue
            self.stats.tokens_out -= len(req.out_tokens)
            self.stats.tokens_discarded += len(req.out_tokens)
            req.out_tokens = []
            req.out_logprobs = []
            active[victim] = None
            pool.free_slot(victim)
            sched.on_preempt(victim)
            sched.requeue_front(req)

        def seat(req: Request, s: int) -> bool:
            if pool.ensure(s, min(len(req.prompt), self.chunk)) is None:
                pool.free_slot(s)
                return False
            active[s] = req
            pos[s] = 0
            sp = req.sampling if req.sampling is not None \
                else self._default_sp
            self._slot_sp[s] = sp
            temp[s] = sp.temperature
            sched.on_admit(s)
            self.stats.prompt_tokens += len(req.prompt)
            return True

        def admit() -> None:
            free_slots = [s for s in range(self.slots) if active[s] is None]
            while free_slots:
                req = sched.next_admission(pool.free_count)
                if req is None:
                    break
                if not seat(req, free_slots[0]):
                    sched.requeue_front(req)
                    break
                free_slots.pop(0)

        while any(a is not None for a in active) or sched.pending:
            sched.start_round()
            admit()
            if not any(a is not None for a in active):
                if sched.pending:
                    raise PoolExhausted(
                        f"queue head needs more than the whole pool "
                        f"({self.n_pages} pages)")
                break
            # plan the round: chunk grants for prefilling lanes, one token
            # per decode lane; every planned lane must own the pages it
            # writes — on exhaustion preempt the youngest younger slot, or
            # self if none is younger (oldest-first order ensures progress)
            plan = {}                       # slot -> chunk tokens
            order = sorted((s for s in range(self.slots)
                            if active[s] is not None),
                           key=lambda s: sched.admitted_at[s])
            for s in order:
                while active[s] is not None:
                    if prefilling(s):
                        n = plan.get(s)
                        if n is None:
                            n = sched.grant_chunk(
                                len(active[s].prompt) - int(pos[s]))
                            if n == 0:
                                break       # budget spent: idle a round
                            plan[s] = n
                        need = int(pos[s]) + n
                    else:
                        need = int(pos[s]) + 1
                    if pool.ensure(s, need) is not None:
                        break
                    victim = sched.choose_victim(s)
                    if victim is not None:
                        plan.pop(victim, None)
                        preempt(victim)
                        continue
                    if not any(active[t] is not None
                               for t in range(self.slots) if t != s):
                        raise PoolExhausted(
                            f"sequence in slot {s} needs {need} tokens of "
                            f"KV but the pool holds {self.n_pages} pages")
                    plan.pop(s, None)
                    preempt(s)      # yield to older slots; retry later
            decode_lanes = [s for s in order if active[s] is not None
                            and not prefilling(s)]
            if not plan and not decode_lanes:
                continue            # everything preempted/idled; re-admit

            max_n = max(plan.values(), default=1)
            c_len = 1 if max_n <= 1 else min(
                [w for w in self._widths if w >= max_n] or [self.chunk])
            toks = np.zeros((self.slots, c_len), np.int32)
            start = np.zeros(self.slots, np.int32)
            n_new = np.zeros(self.slots, np.int32)
            for s in range(self.slots):
                if active[s] is None:
                    continue
                start[s] = pos[s]
                if s in plan:
                    n = plan[s]
                    n_new[s] = n
                    p0 = int(pos[s])
                    toks[s, :n] = active[s].prompt[p0:p0 + n]
                elif not prefilling(s):
                    toks[s, 0] = next_tok[s]
                    n_new[s] = 1
            ts = time.monotonic()
            self.stats.kv_pages_live += sum(
                pages_for(int(pos[s]) + 1, self.page) for s in decode_lanes)
            self.stats.kv_pages_full += (len(decode_lanes)
                                         * self.max_pages_per_seq)
            for s in plan:
                self.stats.prefill_kv_pages_live += chunk_pages_streamed(
                    int(pos[s]), plan[s], page=self.page)
            self._flush_page_ops(pool)
            dev = self.device
            tok_d, logp_d = serve_steps.step(
                self.cfg, self._exec_params,
                torch.as_tensor(toks).to(dev), self._arena,
                torch.as_tensor(start).to(dev),
                torch.as_tensor(n_new).to(dev), temp,
                paged_attention=self.paged_attention)
            nxt = tok_d.cpu().numpy()
            logp_h = logp_d.cpu().numpy()
            if decode_lanes:
                self.stats.decode_steps += 1
            self.stats.rounds += 1

            emitted = 0
            for s in order:
                req = active[s]
                if req is None:
                    continue
                if s in plan:
                    n = plan[s]
                    pos[s] += n
                    self.stats.prefill_chunks += 1
                    self.stats.prefill_tokens += n
                    self.stats.prefill_tokens_padded += c_len
                    if int(pos[s]) < len(req.prompt):
                        continue        # mid-prompt: more chunks due
                    # the logit at the prompt's last token is the
                    # request's first generated token
                    self.stats.prefills += 1
                    tok = int(nxt[s, n - 1])
                    record(s, tok, float(logp_h[s, n - 1]), req)
                    first_token(req)
                    emitted += 1
                    if _finished(req, len(req.prompt), self.max_len):
                        finish(s)       # e.g. EOS at prefill
                    else:
                        next_tok[s] = tok
                elif s in decode_lanes:
                    tok = int(nxt[s, 0])
                    pos[s] += 1
                    next_tok[s] = tok
                    record(s, tok, float(logp_h[s, 0]), req)
                    emitted += 1
                    if _finished(req, int(pos[s]), self.max_len):
                        finish(s)
            self.stats.step_seconds.append(time.monotonic() - ts)
            self.stats.step_tokens.append(emitted)

        self.stats.preemptions = sched.preemptions
        self.stats.pages_peak = max(self.stats.pages_peak, pool.pages_peak)
        self.stats.wall_s = time.monotonic() - t0
        return requests
