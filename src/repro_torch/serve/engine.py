"""Paged continuous-batching engine (counterpart of
``repro.serve.engine.ServeEngine``: its synchronous and pipelined loops,
sampled lanes, the prefix cache with in-flight dedup, and self-speculative
decode).

Every round, all active slots run in ONE ragged step against a shared
paged KV arena: decode lanes carry one token each, prefilling lanes a
chunk of their prompt, both in the same call (``serve/steps.py``), with
FIFO admission, a per-round chunk budget and recompute-style preemption
(``serve/scheduler.py``). Each round runs at the smallest width of the
pow2 ladder (``steps.width_ladder``) that covers its widest grant, C = 1
for pure decode, after one page-ops flush (the round's copy-on-write page
copies and the changed block tables). A round with exactly one live lane
runs the batch-1 ``solo_step`` (``EngineStats.solo_rounds``).

MoE stacks (and hybrid stacks with MoE FFNs) run through the same step:
each expert's rows of the dispatch buffer go through the qmm kernels
against its own streams (``models/moe.py``). An expert's capacity
counts every row of the step, idle lanes and padding included, as in the
reference, so a token's output depends on the width of the step it ran
in: this engine is token-identical to the JAX ``ServeEngine``, not to
the per-slot :class:`LegacyServeEngine`, unless the capacity factor
rules out drops.

Mamba and hybrid stacks keep their SSM and conv state dense per slot
beside the pages: seating a slot queues its state reset into the round's
page-ops flush; decode lanes never share a round with a prefill chunk
(the SSM mixer takes the recurrence at one token and the chunked scan
above, which are not the same sums), so such a round idles them; and the
prefix cache, in-flight dedup and speculative decode are refused (the
state is neither page-addressable nor rolled back), as the JAX engine
refuses them.

The steps come from a step set (``steps.build_paged_steps``, or
``step_set=``, checked against this engine's geometry): on the card each
token width is a captured CUDA graph (``cuda_graphs=True``, the default;
``False`` runs the same steps eagerly, to compare against).

Weights may be dense or QMC streams. With ``weight_plan=False`` (the
default) stream leaves go through the qmm kernels; ``weight_plan=True``
dequantizes them once at construction and the step multiplies dense
weights. ``paged_attention=True`` (the default) attends through the
ragged paged-attention kernel. On ``device="cpu"`` every kernel wrapper
runs its plain PyTorch version.

``mesh=`` (a ``launch.mesh.Mesh``) serves on a ``(data, model)`` mesh of
ranks, as the JAX engine's ``mesh=`` does: every rank runs this host loop
on the same requests, with its slice of the weights (``launch.sharding.
shard_params``: TP over ``model``, replicated over ``data``) and of the
arena (pages over ``data``, KV heads over ``model``, the slots' SSM and
conv rows over ``data`` where the slots divide it), through the mesh
step set (``steps.build_paged_steps(mesh=...)``: eager, no solo lane, so
``cuda_graphs=False`` must be passed), which runs a data rank's share of
the lanes where the slots divide the data axis and every lane where they
do not, as JAX's ``batch_spec`` has it (``EngineStats.rows_per_rank``
says which). The weight plan is off under a
mesh, as in JAX. Every rank's host state and tokens are the same; rank 0
reports. A rank that fails ends its collectives, so its peers raise too
(gloo sees the closed connection; a hung peer hits the group's
timeout). Dense, local/global, MoE (experts over ``model``), SSM and
hybrid stacks, the Mamba2 mixer replicated on every model rank after its
gathered ``in_proj`` (``launch.sharding``); an attention block whose
heads do not divide the model axis (hymba-1.5b's 25 and 5) runs whole on
every model rank; encoder-decoder and VLM stacks are refused, as off the
mesh, and run on a mesh through ``serve.steps.build_prefill`` /
``build_decode``.

Token selection runs inside the step (``serve/sampling.py``): per-request
:class:`~repro_torch.serve.sampling.SamplingParams` ride on
``Request.sampling`` (engine default via ``sampling=``), greedy by
default; sampled lanes draw the JAX package's threefry stream, keyed by
(seed, uid, position).

``prefix_cache=True`` keeps finished prompts' full KV pages in a radix
index (``serve/prefix_cache.py``): an admission whose prompt shares a
cached page-aligned prefix adopts those pages copy-on-write and prefills
only the uncached suffix. The pool, arena and index persist across
``run()`` calls. The scheduler also runs **in-flight dedup**: identical
prompts admitted while an earlier copy occupies a slot alias that slot's
full prompt pages instead of prefilling them again.

``speculative_k > 0`` turns on self-speculative greedy decode: each greedy
decode lane may propose up to k prompt-lookup draft tokens a round
(``serve/speculative.py``), verified in ONE step at the smallest ladder
rung covering ``1 + k``; draft tokens draw on the round's prefill budget
(``FifoScheduler.grant_verify``), and pages of rejected positions go back
through ``PagedKVPool.trim``. Sampled lanes always decode one token.

The pipelined loop (``pipelined=True``), with the JAX engine's contract:

  * **What overlaps.** Only pure-decode rounds with an idle admission
    queue and no verify lane (an engine with ``speculative_k > 0`` never
    overlaps: drafting needs the retired history). The next round's
    tokens are the previous step's output on the device
    (``steps.carry_decode_tokens``), and each dispatch starts a
    non-blocking copy of its outputs to pinned host memory and records an
    event; the round is retired (emission, EOS checks, scheduling) one
    round later, while the next one runs.
  * **What drains.** Admission, preemption, prefill grants and any
    allocation that would need a preemption retire the round in flight
    first and run the next round synchronously.
  * **EOS lag.** Budget and capacity finishes are predicted at dispatch
    (``FifoScheduler.grant_decode``); an EOS retired during the lag
    overran by the one token in flight, which is never emitted: its pages
    are rolled back with ``PagedKVPool.trim``
    (``EngineStats.lag_trimmed_tokens``) and the slot is freed once the
    overrun round retires.

The engine is token-identical to the JAX engine on the same weights, on
greedy, sampled and speculative lanes, cached or not, pipelined or not:
the same admission, chunking, caching and preemption decisions, and
causal attention makes each query independent of how its prompt was
chunked.

Observability (``repro_torch.obs``, the JAX engine's contract): every
round records its phases (``round/admit``, ``round/grant``,
``round/host_prep``, ``round/device_step``, ``round/emit``, and
``round/dispatch`` / ``round/retire`` when pipelined) into
``EngineStats.phase_seconds`` and the ``serve_phase_seconds`` histogram
even with tracing off, and, on an enabled tracer, as spans inside one
``round`` span, with the request lifecycle instants and the
``pool/pages`` / ``sched/queue`` counter tracks; the run's totals go to
the ``serve_*`` metrics (``obs/metrics.py``). On the card
``round/device_step`` closes after the readback event has been waited
on, so device time never shows as host time; in the pipelined loop that
wait is ``round/retire``'s. An enabled tracer also gets the step call's
port-only ``step/stage``, ``step/launch`` (with the round's width, rows,
live rows and lane lengths) and ``step/wait`` spans, and on the card the
device's own clock: a ``device/step`` span of CUDA events around each
round's device work and a ``device/page_ops`` span around each page-ops
flush, anchored at the run's start and resolved at its end into
``EngineStats.device_busy_s`` / ``device_window_s`` / ``device_idle_s``
(the idle time by the host span it overlaps; ``obs/trace.py``). Every
round counts the step's rows (``step_rows``) and live rows
(``step_live_rows``), traced or not. With ``obs.costs`` capture on, the run also
leaves a :class:`~repro_torch.obs.costs.CostReport` in
``last_cost_report``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.qtensor import QTensor
from repro_torch.core.qtensor_sharded import ShardedQTensor
from repro_torch.core.serving_quant import build_exec_weights
from repro_torch.kernels.paged_attention import (Q_BLOCK, q_block_for,
                                                 shard_compatible)
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shd
from repro_torch.memsys.workload import chunk_pages_streamed, pages_for
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import prefill
from repro_torch.obs import costs as obs_costs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import sampling as samplib
from repro_torch.serve import speculative
from repro_torch.serve import steps as serve_steps
from repro_torch.serve.paged_kv import PagedKVPool, PoolExhausted
from repro_torch.serve.prefix_cache import PrefixCache
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
    # token-selection policy; None -> the engine default
    sampling: Optional[SamplingParams] = None
    # selected-token model logprobs, parallel to out_tokens, when the
    # effective SamplingParams has logprobs=True (cleared on preemption)
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
    prompt_tokens: int = 0           # prompt tokens across admissions
    prefill_tokens: int = 0          # tokens actually prefilled (suffixes)
    prefill_tokens_padded: int = 0   # same, after chunk-width padding
    # prefix cache and in-flight dedup (all zero when both are off)
    cache_hits: int = 0              # admissions served partly from cache
    cache_hit_tokens: int = 0        # prompt tokens adopted (cache+dedup)
    dedup_hits: int = 0              # admissions aliasing an in-flight
    #                                  identical prompt's live slot pages
    cow_copies: int = 0              # shared pages privatized on write
    cache_evictions: int = 0         # cached pages evicted under pressure
    # page ops: adoptions and block-table uploads (PagedKVPool counters),
    # COW page copies queued, page-ops calls, and the ops they carried
    # (copies + the table upload)
    adopt_calls: int = 0
    page_copy_calls: int = 0
    device_tables_rebuilds: int = 0
    page_op_flushes: int = 0
    page_ops_batched: int = 0
    # K/V pages the paged-attention kernel streams (decode lanes; prefill
    # chunks per q block, memsys.workload.chunk_pages_streamed) vs the
    # full block-table width the gather route reads
    kv_pages_live: int = 0
    kv_pages_full: int = 0
    prefill_kv_pages_live: int = 0
    prefill_kv_pages_written: int = 0    # page-rounded chunk writes
    # rounds run through the B=1 solo-lane step (exactly one live lane)
    solo_rounds: int = 0
    # pipelined loop: rounds retired one round late, drains of the
    # pipeline before a synchronous round, and tokens computed past an EOS
    # that retired during the lag (trimmed, never emitted)
    pipelined_rounds: int = 0
    pipeline_barriers: int = 0
    lag_trimmed_tokens: int = 0
    # self-speculative decode: rounds that carried a verify lane, draft
    # tokens proposed, and draft tokens the model accepted
    spec_rounds: int = 0
    spec_draft_tokens: int = 0
    spec_accepted_tokens: int = 0
    # lanes this rank runs through the layers outside attention: the
    # engine's slots, or a data rank's share where the mesh step set
    # splits them (launch.sharding.serve_rows)
    rows_per_rank: int = 0
    # the step set's graphs during this run: captures, their seconds,
    # replays (all 0 off the card or with cuda_graphs=False)
    graph_captures: int = 0
    capture_s: float = 0.0
    graph_replays: int = 0
    # rows the step computed (lanes run x C: [slots, C], or [1, C] on the
    # solo lane) and the live ones among them (Σ n_new: chunk tokens, one
    # per decode lane, verify drafts), every round
    step_rows: int = 0
    step_live_rows: int = 0
    # per round: wall seconds from its dispatch to its emission (a
    # pipelined round's comes one round later) and tokens emitted; per
    # request: seconds from run() start to its first token
    step_seconds: List[float] = dataclasses.field(default_factory=list)
    step_tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    # cumulative wall seconds per round phase (span names per the
    # obs/trace.py contract), recorded with tracing off too
    phase_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # per request (uid): the time.monotonic() of each emission; a
    # preempted request's discarded emissions are dropped with its tokens
    emit_times: Dict[int, List[float]] = dataclasses.field(
        default_factory=dict)
    # the device clock of a traced run on the card (None off the card or
    # with tracing off; obs/trace.py): the union of the device/* spans
    # inside the run's window, the window (the clock's anchor, after a
    # synchronize, to the loop's end), and the window's idle device
    # seconds by the innermost host span open over them (round/*, step/*,
    # "round", or "between rounds"; obs.trace.idle_by_span), which sum to
    # window - busy
    device_busy_s: Optional[float] = None
    device_window_s: Optional[float] = None
    device_idle_s: Optional[Dict[str, float]] = None

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s else 0.0

    @property
    def page_op_round_trips_saved(self) -> int:
        """Page-ops calls the batching avoided (one call per op)."""
        return max(0, self.page_ops_batched - self.page_op_flushes)

    def itl_s(self) -> List[float]:
        """Per-request inter-token latencies: the gaps between a request's
        consecutive emissions."""
        gaps: List[float] = []
        for times in self.emit_times.values():
            gaps.extend(b - a for a, b in zip(times, times[1:]))
        return gaps

    _DEVICE_PHASES = ("round/device_step", "round/dispatch",
                      "round/retire")

    def host_seconds(self) -> float:
        """Wall seconds in the host-side round phases: admission, grants,
        host input prep and page ops, emission. The step call, the
        pipelined dispatch and the pipelined retire (the readback wait,
        with the emission bookkeeping inside it charged to the device
        side, as the JAX engine does) are device time."""
        return sum(v for k, v in self.phase_seconds.items()
                   if k not in self._DEVICE_PHASES)

    def device_seconds(self) -> float:
        """Wall seconds in the step call and the readback wait (the
        synchronous step, the pipelined dispatch and retire), graph
        captures on a new width included (``capture_s`` bounds them)."""
        return sum(self.phase_seconds.get(k, 0.0)
                   for k in self._DEVICE_PHASES)

    @property
    def pipeline_overlap(self) -> float:
        """Fraction of rounds retired through the pipeline."""
        return self.pipelined_rounds / self.rounds if self.rounds else 0.0

    @property
    def spec_acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the model accepted."""
        return (self.spec_accepted_tokens / self.spec_draft_tokens
                if self.spec_draft_tokens else 0.0)

    @property
    def hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from cached pages."""
        return (self.cache_hit_tokens / self.prompt_tokens
                if self.prompt_tokens else 0.0)

    @property
    def prefill_token_reduction(self) -> float:
        """1 - (tokens prefilled / tokens a cache-less engine prefills)."""
        return (1.0 - self.prefill_tokens / self.prompt_tokens
                if self.prompt_tokens else 0.0)


def _finished(req: Request, pos: int, max_len: int) -> bool:
    """Budget spent, EOS emitted, or the cache is full (pos == max_len)."""
    return (len(req.out_tokens) >= req.max_new_tokens
            or (req.eos_id is not None and req.out_tokens
                and req.out_tokens[-1] == req.eos_id)
            or pos >= max_len)


class _PhaseSpan:
    """Times one round phase: accumulates into ``EngineStats.
    phase_seconds``, observes the ``serve_phase_seconds{phase}``
    histogram, and (when tracing is on) records the span on the tracer.
    A plain class, so a phase costs two ``perf_counter`` calls with
    tracing off."""

    __slots__ = ("name", "tracer", "hist", "stats", "t0")

    def __init__(self, name, tracer, hist, stats):
        self.name, self.tracer, self.hist = name, tracer, hist
        self.stats = stats

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        ph = self.stats.phase_seconds
        ph[self.name] = ph.get(self.name, 0.0) + dt
        self.hist.observe(dt, phase=self.name)
        self.tracer.complete(self.name, self.t0, dt)
        return False


def tree_to(tree, device):
    """Move a parameter tree (dicts, tensors, QTensors and
    ShardedQTensors, per-group lists of them) to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, (torch.Tensor, QTensor, ShardedQTensor)):
        return tree.to(device)
    return tree


class ServeEngine:
    """Continuous batching over a paged KV pool (see the module
    docstring). ``slots`` bounds concurrent sequences; ``max_len`` is each
    sequence's capacity (prompt + generated); ``n_pages`` sizes the pool
    (default: every slot at full length). ``tracer`` and ``metrics`` plug
    the engine into ``repro_torch.obs`` (default: the process instances;
    the default tracer is disabled)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, cache_dtype=torch.float32,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 max_prefill_tokens: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 prefix_cache: bool = False,
                 inflight_dedup: Optional[bool] = None,
                 paged_attention: bool = True, weight_plan: bool = False,
                 sampling: Optional[SamplingParams] = None,
                 speculative_k: int = 0,
                 step_set: Optional[serve_steps.PagedServeSteps] = None,
                 pipelined: bool = False, cuda_graphs: bool = True,
                 device="cuda", mesh=None,
                 tracer: Optional[obs_trace.Tracer] = None,
                 metrics: Optional[obs_metrics.Registry] = None):
        if cfg.is_encdec or cfg.n_vis_tokens:
            raise NotImplementedError(
                "the paged engine covers decoder-only models; a VLM serves "
                "text-only through LegacyServeEngine, an encoder-decoder "
                "through models.model.prefill / decode_step, and both on "
                "a mesh through serve.steps.build_prefill / build_decode")
        attn_only = all(k.startswith("attn") for k in cfg.pattern)
        if (prefix_cache or inflight_dedup) and not attn_only:
            raise NotImplementedError(
                "prefix caching / in-flight dedup share attention KV "
                "pages; SSM/conv state is not page-addressable — disable "
                f"them for hybrid/mamba stacks (pattern={cfg.pattern})")
        if speculative_k > 0 and not attn_only:
            raise NotImplementedError(
                "self-speculative decode rolls rejected positions back "
                "via valid_len masking + page trim; SSM/conv state has "
                "no per-position rollback — attention-only stacks only "
                f"(pattern={cfg.pattern})")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            if cuda_graphs:
                raise ValueError("a mesh engine runs its steps eagerly: "
                                 "pass cuda_graphs=False")
            params = shd.shard_params(params, mesh, cfg)
        self.params = tree_to(params, self.device)
        self.slots = slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.page = page_size
        self.max_pages_per_seq = pages_for(max_len, page_size)
        self.n_pages = n_pages or serve_steps.default_n_pages(
            slots, self.max_pages_per_seq, mesh)
        # the rank's slice of the arena's pages (a data axis over 1)
        self._page_slice = None
        if mesh is not None:
            if not shard_compatible(mesh, self.n_pages + 1):
                raise ValueError(
                    f"{self.n_pages} + 1 arena pages must divide the "
                    f"mesh's data axis {mesh.shape}")
            if meshlib.axis_size(mesh, "data") > 1:
                self._page_slice = shd.page_slice(self.n_pages + 1, mesh)
        self.max_prefill_tokens = (max_prefill_tokens
                                   or max(512, bucket_len(max_len,
                                                          page_size)))
        self.chunk = chunk_tokens or serve_steps.default_chunk(
            self.max_pages_per_seq, page_size)
        self._widths = serve_steps.width_ladder(self.chunk)
        # the attention kernel's q block, which the prefill stream account
        # counts with (a rank's heads, a slice or all of them, keep the
        # group size)
        kv_pages_dtype = torch.int8 if cfg.kv_cache_quant else cache_dtype
        self.q_block = (q_block_for(cfg.n_heads // cfg.n_kv_heads,
                                    cfg.head_dim, kv_pages_dtype,
                                    self.max_pages_per_seq, page_size)
                        if cfg.n_kv_heads else Q_BLOCK)
        self.paged_attention = paged_attention
        self.stats = EngineStats()
        self._tracer = tracer          # None -> process default at run()
        self._metrics = metrics
        # token selection: the engine default (per-request sampling
        # overrides), the per-lane table the step's sampling inputs are
        # staged from, and the draft length of a verify round (0 = off)
        self._default_sp = sampling or samplib.GREEDY
        self._samp = samplib.lane_inputs(slots)
        self._slot_sp: List[SamplingParams] = [samplib.GREEDY] * slots
        self._spec_k = int(speculative_k)
        self._pipelined = bool(pipelined)
        self._cuda_graphs = bool(cuda_graphs)
        self._dedup = attn_only if inflight_dedup is None \
            else bool(inflight_dedup)
        # co-scheduling a 1-token decode into a C-wide step is exact for
        # attention (queries are independent) but not for the SSM scan
        # (s == 1 takes the O(1) recurrence, s > 1 the chunked SSD):
        # hybrid and mamba stacks run chunk rounds and decode rounds
        # apart, as the JAX engine does
        self._co_schedule = attn_only
        if step_set is not None and (
                step_set.cfg != cfg or step_set.device != self.device
                or step_set.mesh is not mesh
                or step_set.page_slice != self._page_slice
                or not step_set.compatible_with(
                    page=self.page, n_pages=self.n_pages, max_slots=slots,
                    max_pages_per_seq=self.max_pages_per_seq,
                    cache_dtype=cache_dtype, chunk=self.chunk,
                    paged_attention=paged_attention)):
            raise ValueError(
                "step_set was built for a different engine geometry "
                "(cfg/device/mesh/page/n_pages/slots/cache_dtype/chunk/"
                "paged_attention must match)")
        self._steps = step_set
        # the serving weight plan: streams dequantized once, at setup
        # (single device only: a mesh engine runs its shards' streams)
        self._exec_params = (build_exec_weights(self.params)
                             if weight_plan and mesh is None
                             else self.params)
        # COW page copies and state resets queued by seat(), flushed
        # once per round in one page-ops call
        self._pending_copies: List = []
        self._pending_resets: List[int] = []
        # pool + arena (+ prefix index) persist across run() calls
        self._use_prefix = bool(prefix_cache)
        self._pool: Optional[PagedKVPool] = None
        self._arena = None
        self.prefix_cache: Optional[PrefixCache] = None
        # the last run's cost attribution, when obs.costs capture is on
        self.last_cost_report: Optional[obs_costs.CostReport] = None

    def _ensure_pool(self) -> PagedKVPool:
        """The pool and arena, made once per engine: the step set's graphs
        read the arena by address, so it is never reallocated."""
        if self._pool is None:
            self._pool = PagedKVPool(
                self.cfg, n_pages=self.n_pages, page=self.page,
                max_slots=self.slots,
                max_pages_per_seq=self.max_pages_per_seq,
                cache_dtype=self.cache_dtype, device=self.device)
            if self.mesh is None:
                self._arena = self._pool.init_arena()
            else:
                self._arena = shd.local_arena(
                    self.cfg, self.n_pages + 1, self.page, self.slots,
                    self.max_pages_per_seq, self.cache_dtype, self.device,
                    self.mesh)
            if self._steps is None:
                self._steps = serve_steps.build_paged_steps(
                    self.cfg, page=self.page, n_pages=self.n_pages,
                    max_slots=self.slots,
                    max_pages_per_seq=self.max_pages_per_seq,
                    cache_dtype=self.cache_dtype, chunk=self.chunk,
                    paged_attention=self.paged_attention,
                    device=self.device, cuda_graphs=self._cuda_graphs,
                    mesh=self.mesh, page_slice=self._page_slice)
            if self._use_prefix:
                self.prefix_cache = PrefixCache(self._pool,
                                                tracer=self._tracer)
        return self._pool

    @property
    def step_set(self) -> Optional[serve_steps.PagedServeSteps]:
        return self._steps

    def _flush_page_ops(self, pool: PagedKVPool,
                        trc: obs_trace.Tracer) -> None:
        """The round's queued page copies, state resets and changed block
        tables in one page-ops call (more than ``slots`` copies drain in
        extra calls; the resets ride with the first); a round with nothing
        queued and clean tables skips it. On the card with tracing on, a
        ``device/page_ops`` span covers the calls' device work."""
        copies, resets = self._pending_copies, self._pending_resets
        if not (copies or resets or pool.tables_dirty):
            return
        pool.check_tables()
        n_ops = len(copies) + len(resets) + 1
        dev = trc.device_span("device/page_ops")
        first = True
        while first or copies:
            batch, copies[:] = copies[:self.slots], copies[self.slots:]
            self._steps.apply_page_ops(
                self._arena, pool.block_tables, batch,
                resets if first else (), mark=dev.begin if first else None)
            self.stats.page_op_flushes += 1
            first = False
        dev.end()
        pool.tables_rebuilds += 1
        pool.tables_dirty = False
        self.stats.page_ops_batched += n_ops
        resets.clear()

    def _alloc(self, slot: int, n_tokens: int) -> Optional[List[int]]:
        """pool.ensure with LRU eviction of unpinned cached pages as the
        fallback; None only when eviction cannot help either."""
        while True:
            fresh = self._pool.ensure(slot, n_tokens)
            if fresh is not None:
                return fresh
            if self.prefix_cache is None or not self.prefix_cache.evict(1):
                return None
            self.stats.cache_evictions += 1

    def run(self, requests: List[Request]) -> List[Request]:
        """Process all requests to completion; returns them with outputs.

        A generated ``eos_id`` is emitted and generation stops right after
        (speculative acceptance truncates at the first EOS); a preempted
        request starts over from its first token. With ``logprobs=True``
        the selected tokens' model logprobs land in
        ``request.out_logprobs``. Stats describe this run only; the prefix
        cache and its pages persist across calls."""
        self.stats = EngineStats()
        t0 = time.monotonic()
        for r in requests:
            if len(r.prompt) > self.max_len:
                raise ValueError(f"request {r.uid}: prompt length "
                                 f"{len(r.prompt)} > max_len={self.max_len}")
        pool = self._ensure_pool()
        steps = self._steps
        self.stats.rows_per_rank = steps.rows_per_rank
        # observability: the explicit tracer/registry or the process
        # defaults (the default tracer is disabled: every span site is
        # then one branch)
        trc = obs_trace.active(self._tracer)
        reg = self._metrics if self._metrics is not None \
            else obs_metrics.get_registry()
        phase_hist = reg.histogram(
            "serve_phase_seconds", "per-round phase wall time",
            labels=("phase",))

        def phase(name: str) -> _PhaseSpan:
            return _PhaseSpan(name, trc, phase_hist, self.stats)

        # the device clock of a traced run on the card: anchored here,
        # resolved after the loop
        clock = trc.enabled and self.device.type == "cuda"
        if clock:
            trc.device_anchor()
            ev0, t_clock0 = len(trc.events), time.perf_counter()

        # release slot pages an aborted run may have left mapped (cached
        # pages survive) and re-base the pool's counters
        for s in range(self.slots):
            if pool.slot_pages[s]:
                pool.free_slot(s)
        pool.pages_peak = pool.used_count
        self._pending_copies.clear()
        self._pending_resets.clear()
        cow0, adopt0 = pool.cow_copies, pool.adopt_calls
        tbl0 = pool.tables_rebuilds
        _, cap0, cap_s0 = steps.capture_counters()
        replays0 = steps.replays
        cost0 = obs_costs.snapshot(steps) \
            if obs_costs.capture_enabled() else None
        admissions = {"miss": 0, "hit": 0, "dedup": 0}
        cache = self.prefix_cache
        sched = FifoScheduler(SchedulerConfig(
            page=self.page, max_prefill_tokens=self.max_prefill_tokens,
            max_len=self.max_len, chunk=self.chunk), prefix_cache=cache,
            pool=pool if self._dedup else None, tracer=trc)
        for r in requests:
            sched.enqueue(r)

        active: List[Optional[Request]] = [None] * self.slots
        pos = np.zeros(self.slots, np.int64)      # next write position
        next_tok = np.zeros(self.slots, np.int64)
        seen_first: set = set()
        cuda = self.device.type == "cuda"

        def prefilling(s: int) -> bool:
            return (active[s] is not None
                    and pos[s] < len(active[s].prompt))

        def record(s: int, tok: int, logp: float, req: Request) -> None:
            assert tok != samplib.DEAD_TOKEN, \
                f"emit read a dead lane (slot {s})"
            req.out_tokens.append(tok)
            if self._slot_sp[s].logprobs:
                req.out_logprobs.append(logp)
            self.stats.tokens_out += 1

        def emit(s: int, req: Request, now: float) -> None:
            """An emission's timestamp; the request's first token (once
            across preemption) also stamps its TTFT."""
            self.stats.emit_times.setdefault(req.uid, []).append(now)
            if req.uid not in seen_first:
                seen_first.add(req.uid)
                self.stats.ttft_s.append(now - t0)
                trc.instant("req/first_token", uid=req.uid, slot=s)

        def publish(req: Request, s: int) -> None:
            """Index the slot's full prompt pages (prefill KV reuse)."""
            if cache is not None:
                n_full = len(req.prompt) // self.page
                if n_full:
                    cache.insert(req.prompt, pool.slot_pages[s][:n_full])

        def finish(s: int, defer_rec=None) -> None:
            req = active[s]
            req.done = True
            active[s] = None
            if defer_rec is not None and s in defer_rec["act_dec"]:
                # EOS during the lag: the round in flight computed one more
                # token on this lane; its pages stay mapped until that
                # round retires, then the overrun is trimmed
                defer_rec["lag_free"].add(s)
            else:
                pool.free_slot(s)
            sched.on_finish(s)
            trc.instant("req/finished", uid=req.uid, slot=s,
                        tokens=len(req.out_tokens))

        def preempt(victim: int) -> None:
            req = active[victim]
            # recompute-style eviction: drop generated state, requeue; a
            # lane preempted mid-prompt releases exactly the pages its
            # chunks wrote (plus its adopted references)
            trc.instant("req/preempted", uid=req.uid, slot=victim,
                        discarded=len(req.out_tokens))
            self.stats.tokens_out -= len(req.out_tokens)
            self.stats.tokens_discarded += len(req.out_tokens)
            # discarded emissions contribute no inter-token gaps
            self.stats.emit_times.pop(req.uid, None)
            req.out_tokens = []
            req.out_logprobs = []
            active[victim] = None
            pool.free_slot(victim)
            sched.on_preempt(victim)
            sched.requeue_front(req)

        def seat(adm, s: int) -> bool:
            """Seat an admission: adopt cached pages, allocate the first
            chunk's pages, COW the shared page a mid-page restart writes
            into (the copy is queued for the round's page-ops flush). No
            step runs here. False when pages ran out."""
            req = adm.req
            L = len(req.prompt)
            start = adm.suffix_start
            if adm.cached_pages:
                pool.adopt(s, adm.cached_pages)
            if self._alloc(s, min(L, start + self.chunk)) is None:
                pool.free_slot(s)
                return False
            cow = pool.cow(s, start) if adm.cached_pages else None
            while cow is False:
                if cache is None or not cache.evict(1):
                    pool.free_slot(s)
                    return False
                self.stats.cache_evictions += 1
                cow = pool.cow(s, start)
            if cow is not None:
                self._pending_copies.append(cow)
                self.stats.page_copy_calls += 1
            if steps.reset_state is not None:
                # the slot's SSM/conv rows start from zero, zeroed in the
                # round's page-ops flush before its first chunk runs
                self._pending_resets.append(s)
            active[s] = req
            pos[s] = start
            sp = req.sampling if req.sampling is not None \
                else self._default_sp
            self._slot_sp[s] = sp
            samplib.set_lane(self._samp, s, sp, req.uid)
            sched.on_admit(s)
            sched.note_progress(s, start)
            if adm.cached_pages:
                if adm.dedup:
                    self.stats.dedup_hits += 1
                    admissions["dedup"] += 1
                else:
                    self.stats.cache_hits += 1
                    admissions["hit"] += 1
                self.stats.cache_hit_tokens += start
            else:
                admissions["miss"] += 1
                sched.note_prefill(req, s)
                if cache is not None:
                    sched.miss_open(s)
            self.stats.prompt_tokens += L
            trc.instant("req/admitted", uid=req.uid, slot=s,
                        cached_tokens=start, dedup=adm.dedup)
            return True

        def admit() -> None:
            free_slots = [s for s in range(self.slots) if active[s] is None]
            while free_slots:
                capacity = pool.free_count + (cache.evictable_pages()
                                              if cache else 0)
                adm = sched.next_admission(capacity)
                if adm is None:
                    break
                s = free_slots[0]
                ok = seat(adm, s)
                if not ok and adm.cached_pages:
                    # the hit pinned its matched pages, which may be the
                    # very pages the capacity check promised as evictable:
                    # degrade to an uncached admission that can evict them
                    adm.cached_pages, adm.cached_len = [], 0
                    adm.dedup = False
                    ok = seat(adm, s)
                if not ok:          # promised pages vanished; retry later
                    sched.requeue_front(adm.req)
                    break
                free_slots.pop(0)

        # ---- dispatch / retire: every round is dispatched once and
        # emitted once; the synchronous path gathers at once, the
        # pipelined path one round later

        def process_round(rec, nxt, logp_h, now=None, defer_rec=None):
            """Emission, EOS and scheduling for one completed round;
            returns the tokens emitted. ``now`` stamps every emission of
            the round (a retire passes its readback-complete time);
            ``defer_rec`` is the round still in flight, whose lanes defer
            their page frees to its retire."""
            plan, verify = rec["plan"], rec["verify"]
            act_dec, n_new = rec["act_dec"], rec["n_new"]
            c_len = rec["c_len"]
            now_t = time.monotonic() if now is None else now
            emitted = 0
            for s in rec["order"]:
                req = active[s]
                if req is None:
                    continue
                if s in plan:
                    n = plan[s]
                    pos[s] += n
                    sched.note_progress(s, int(pos[s]))
                    self.stats.prefill_chunks += 1
                    self.stats.prefill_tokens += n
                    self.stats.prefill_tokens_padded += c_len
                    trc.instant("req/chunk_done", uid=req.uid, slot=s,
                                pos=int(pos[s]))
                    if int(pos[s]) < len(req.prompt):
                        continue        # mid-prompt: more chunks due
                    # the logit at the prompt's last token is the
                    # request's first generated token
                    self.stats.prefills += 1
                    publish(req, s)
                    sched.miss_closed(s)
                    tok = int(nxt[s, n - 1])
                    record(s, tok, float(logp_h[s, n - 1]), req)
                    emitted += 1
                    if _finished(req, len(req.prompt), self.max_len):
                        # e.g. EOS at prefill: never enters a decode
                        # round, so its events carry slot -1
                        req.done = True
                        active[s] = None
                        pool.free_slot(s)
                        sched.on_finish(s)
                        emit(-1, req, now_t)
                        trc.instant("req/finished", uid=req.uid, slot=-1,
                                    tokens=len(req.out_tokens))
                    else:
                        next_tok[s] = tok
                        emit(s, req, now_t)
                elif s in act_dec:
                    # plain decode is a verify round with an empty draft:
                    # accept_greedy keeps the verified draft prefix and
                    # the model's correction token
                    n = int(n_new[s])
                    draft = verify.get(s)
                    if draft is not None:
                        n_acc = speculative.accept_greedy(draft, nxt[s, :n])
                        self.stats.spec_draft_tokens += len(draft)
                        self.stats.spec_accepted_tokens += n_acc - 1
                    else:
                        n_acc = 1
                    fin = False
                    for j in range(n_acc):
                        tok = int(nxt[s, j])
                        pos[s] += 1
                        next_tok[s] = tok
                        record(s, tok, float(logp_h[s, j]), req)
                        emitted += 1
                        emit(s, req, now_t)
                        if _finished(req, int(pos[s]), self.max_len):
                            # accepted tokens past EOS (or the budget) are
                            # discarded
                            finish(s, defer_rec)
                            fin = True
                            break
                    if draft is not None and not fin and n_acc < n:
                        # speculative rollback: the pages of rejected
                        # positions go back; their K/V stays masked by
                        # valid_len until real tokens overwrite it
                        pool.trim(s, int(pos[s]))
            self.stats.step_seconds.append(now_t - rec["ts"])
            self.stats.step_tokens.append(emitted)
            return emitted

        def dispatch(rec, toks_in, start, n_new, pipelined: bool) -> None:
            """The round's one step call and the start of its readback
            (``rec["tok_dev"]``, ``rec["logp_dev"]``, ``rec["ready"]``);
            never waits for the device. With tracing on: ``step/stage``,
            then ``step/launch`` over the replay and the readback's
            enqueue, and on the card a ``device/step`` span from the
            upload through the readback copy."""
            s0 = rec["solo_slot"]
            if s0 is None:
                fn, slot = steps.step, 0
                args = (toks_in, self._arena, start, n_new, self._samp)
            else:
                fn, slot = steps.solo_step, s0
                args = (toks_in, self._arena, start[s0:s0 + 1],
                        n_new[s0:s0 + 1],
                        {k: v[s0:s0 + 1] for k, v in self._samp.items()})
                self.stats.solo_rounds += 1
            rows = fn.lanes * rec["c_len"]
            live = int(n_new.sum())
            self.stats.step_rows += rows
            self.stats.step_live_rows += live
            if not trc.enabled:
                rec["tok_dev"], rec["logp_dev"] = fn(
                    self._exec_params, *args, slot=slot)
                readback(rec)
                return
            dev = trc.device_span("device/step")
            with trc.span("step/stage"):
                staged = fn.stage(self._exec_params, *args, slot=slot,
                                  mark=dev.begin)
            kv = (start + n_new)[n_new > 0].tolist()
            with trc.span("step/launch", c=rec["c_len"], rows=rows,
                          live=live, solo=s0 is not None,
                          pipelined=pipelined, kv=kv):
                rec["tok_dev"], rec["logp_dev"] = fn.launch(staged)
                readback(rec)
                dev.end()

        def readback(rec) -> None:
            """Start the copy of the round's outputs to the host: into
            pinned memory, behind an event, on the card (the step's
            static outputs are rewritten by the next call at its width,
            which the stream orders after this copy)."""
            tok_d, logp_d = rec["tok_dev"], rec["logp_dev"]
            if cuda:
                rec["tok_host"] = torch.empty(tok_d.shape, dtype=tok_d.dtype,
                                              pin_memory=True)
                rec["logp_host"] = torch.empty(logp_d.shape,
                                               dtype=logp_d.dtype,
                                               pin_memory=True)
                rec["tok_host"].copy_(tok_d, non_blocking=True)
                rec["logp_host"].copy_(logp_d, non_blocking=True)
                rec["ready"] = torch.cuda.Event()
                rec["ready"].record()
            else:
                rec["tok_host"] = tok_d.clone()
                rec["logp_host"] = logp_d.clone()
                rec["ready"] = None

        def gather(rec):
            """The round's outputs as full-width host arrays (dead lanes
            carry DEAD_TOKEN); waits for the readback."""
            with trc.span("step/wait"):
                if rec["ready"] is not None:
                    rec["ready"].synchronize()
            tok = rec["tok_host"].numpy()
            logp = rec["logp_host"].numpy()
            s0 = rec["solo_slot"]
            if s0 is None:
                return tok, logp
            nxt = np.full((self.slots, rec["c_len"]), samplib.DEAD_TOKEN,
                          np.int64)
            logp_h = np.zeros((self.slots, rec["c_len"]), np.float32)
            nxt[s0] = tok[0]
            logp_h[s0] = logp[0]
            return nxt, logp_h

        def retire(rec, defer_rec=None) -> int:
            """The readback wait and emission of a pipelined round. Lanes
            whose EOS retired during the lag trim their overrun token's
            pages and free their slot here, once the round that computed
            past the EOS is done."""
            with phase("round/retire"):
                nxt, logp_h = gather(rec)
                emitted = process_round(rec, nxt, logp_h,
                                        now=time.monotonic(),
                                        defer_rec=defer_rec)
                for s in sorted(rec["lag_free"]):
                    self.stats.lag_trimmed_tokens += int(rec["n_new"][s])
                    pool.trim(s, int(pos[s]))
                    pool.free_slot(s)
            return emitted

        def round_done(r_t0: float, lanes: int, prefill_lanes: int,
                       decode_lanes: int, emitted: int) -> None:
            """The round's pool and queue counter samples and its
            ``round`` span."""
            trc.counter("pool/pages", live=pool.used_count,
                        free=pool.free_count)
            trc.counter("sched/queue", prefill_pending=sched.pending)
            trc.complete("round", r_t0, time.perf_counter() - r_t0,
                         lanes=lanes, prefill_lanes=prefill_lanes,
                         decode_lanes=decode_lanes, emitted=emitted)

        inflight = None            # the dispatched round not yet retired

        while any(a is not None for a in active) or sched.pending:
            r_t0 = time.perf_counter()
            if inflight is not None:
                # ---- pipelined: grant pure-decode lanes against the
                # round in flight, carry its tokens on the device into the
                # next dispatch, then retire it
                dec: List[int] = []
                order: List[int] = []
                barrier = bool(sched.pending) and any(a is None
                                                      for a in active)
                if not barrier:
                    with phase("round/grant"):
                        order = sorted((s for s in range(self.slots)
                                        if active[s] is not None),
                                       key=lambda s: sched.admitted_at[s])
                        for s in order:
                            req = active[s]
                            if not sched.grant_decode(
                                    len(req.out_tokens), req.max_new_tokens,
                                    int(pos[s]), self.max_len, lead=1):
                                continue    # its last token retires now
                            if s not in inflight["act_dec"]:
                                barrier = True      # no carried token
                                break
                            if self._alloc(s, int(pos[s]) + 2) is None:
                                barrier = True      # needs a preemption
                                break
                            dec.append(s)
                if barrier or not dec:
                    # drain, then run the next round synchronously
                    self.stats.pipeline_barriers += 1
                    prev, inflight = inflight, None
                    retire(prev)
                    continue
                with phase("round/host_prep"):
                    start = np.zeros(self.slots, np.int32)
                    n_new = np.zeros(self.slots, np.int32)
                    for s in dec:
                        start[s] = int(pos[s]) + 1  # the in-flight token's
                        n_new[s] = 1                # position + 1
                    ts = time.monotonic()
                    self.stats.kv_pages_live += sum(
                        pages_for(int(start[s]) + 1, self.page) for s in dec)
                    self.stats.kv_pages_full += (len(dec)
                                                 * self.max_pages_per_seq)
                    self._flush_page_ops(pool, trc)
                    s0 = (dec[0] if len(dec) == 1 and steps.solo_step
                          is not None else None)
                with phase("round/dispatch"):
                    tok_in = serve_steps.carry_decode_tokens(
                        inflight["tok_dev"], s0)
                    rec = {"order": dec, "plan": {}, "verify": {},
                           "act_dec": dec, "n_new": n_new, "c_len": 1,
                           "ts": ts, "solo_slot": s0, "lag_free": set()}
                    dispatch(rec, tok_in, start, n_new, pipelined=True)
                self.stats.decode_steps += 1
                self.stats.rounds += 1
                self.stats.pipelined_rounds += 1
                prev, inflight = inflight, rec
                emitted = retire(prev, defer_rec=rec)
                round_done(r_t0, len(order), 0, len(dec), emitted)
                continue

            with phase("round/admit"):
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
            # writes — on exhaustion first evict unpinned cached pages,
            # then preempt the youngest younger slot, or self if none is
            # younger (oldest-first order ensures progress)
            plan = {}                       # slot -> chunk tokens
            with phase("round/grant"):
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
                                    break   # budget spent: idle a round
                                plan[s] = n
                            need = int(pos[s]) + n
                        else:
                            need = int(pos[s]) + 1
                        if self._alloc(s, need) is not None:
                            break
                        victim = sched.choose_victim(s)
                        if victim is not None:
                            plan.pop(victim, None)
                            preempt(victim)
                            continue
                        if not any(active[t] is not None
                                   for t in range(self.slots) if t != s):
                            raise PoolExhausted(
                                f"sequence in slot {s} needs {need} tokens "
                                f"of KV but the pool holds {self.n_pages} "
                                f"pages")
                        plan.pop(s, None)
                        preempt(s)  # yield to older slots; retry later
                decode_lanes = [s for s in order if active[s] is not None
                                and not prefilling(s)]
                run_decode = bool(decode_lanes) and (self._co_schedule
                                                     or not plan)
                # self-speculative decode: draft up to k tokens per greedy
                # decode lane (prompt lookup over its own history) for one
                # verify step on a ladder rung. Drafts are optional work:
                # they draw on the round budget after prefill grants and
                # take pages WITHOUT preemption; any shortfall decodes one
                # token as usual
                verify: Dict[int, np.ndarray] = {}
                if run_decode and self._spec_k > 0:
                    for s in decode_lanes:
                        req = active[s]
                        if self._slot_sp[s].temperature > 0:
                            continue        # greedy acceptance only
                        want = min(self._spec_k, self.chunk - 1,
                                   self.max_len - int(pos[s]) - 1,
                                   req.max_new_tokens
                                   - len(req.out_tokens) - 1)
                        if want <= 0:
                            continue
                        hist = np.concatenate(
                            [np.asarray(req.prompt, np.int64),
                             np.asarray(req.out_tokens, np.int64)])
                        draft = speculative.propose(hist, want)
                        if draft.size == 0:
                            continue
                        granted = sched.grant_verify(len(draft))
                        if granted == 0:
                            continue
                        draft = draft[:granted]
                        if self._alloc(
                                s, int(pos[s]) + 1 + len(draft)) is None:
                            continue
                        verify[s] = draft
            if not plan and not run_decode:
                continue            # everything preempted/idled; re-admit

            with phase("round/host_prep"):
                # the smallest width covering the widest grant: a prefill
                # chunk or a verify (1 + draft); pure decode stays at C = 1
                max_n = max([max(plan.values(), default=0)]
                            + [1 + len(d) for d in verify.values()])
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
                    elif not prefilling(s) and run_decode:
                        d = verify.get(s)
                        toks[s, 0] = next_tok[s]
                        if d is None:
                            n_new[s] = 1
                        else:
                            n_new[s] = 1 + len(d)
                            toks[s, 1:1 + len(d)] = d
                ts = time.monotonic()
                act_dec = decode_lanes if run_decode else []
                if verify:
                    self.stats.spec_rounds += 1
                self.stats.kv_pages_live += sum(
                    pages_for(int(pos[s]) + int(n_new[s]), self.page)
                    for s in act_dec)
                self.stats.kv_pages_full += (len(act_dec)
                                             * self.max_pages_per_seq)
                for s in plan:
                    self.stats.prefill_kv_pages_live += chunk_pages_streamed(
                        int(pos[s]), plan[s], page=self.page,
                        q_block=self.q_block)
                    self.stats.prefill_kv_pages_written += (
                        pages_for(int(pos[s]) + plan[s], self.page)
                        - int(pos[s]) // self.page)
                self._flush_page_ops(pool, trc)
                live = np.flatnonzero(n_new > 0)
                s0 = (int(live[0]) if len(live) == 1 and steps.solo_step
                      is not None else None)
            # a pure-decode round with an idle queue enters the pipeline
            # (never a verify round, nor any round of a speculative
            # engine): it retires one round from now
            overlap = (self._pipelined and run_decode and not plan
                       and not verify and self._spec_k == 0
                       and not sched.pending)
            with phase("round/dispatch" if overlap
                       else "round/device_step"):
                rec = {"order": order, "plan": plan, "verify": verify,
                       "act_dec": act_dec, "n_new": n_new,
                       "c_len": c_len, "ts": ts, "solo_slot": s0,
                       "lag_free": set()}
                dispatch(rec, toks if s0 is None else toks[s0:s0 + 1],
                         start, n_new, pipelined=overlap)
                if not overlap:
                    nxt, logp_h = gather(rec)   # ends after the readback
            if act_dec:
                self.stats.decode_steps += 1
            self.stats.rounds += 1
            if overlap:
                self.stats.pipelined_rounds += 1
                inflight = rec
                emitted = 0         # emitted at its retire, next round
            else:
                with phase("round/emit"):
                    emitted = process_round(rec, nxt, logp_h)
            round_done(r_t0, len(order), len(plan), len(act_dec), emitted)

        if inflight is not None:
            # every lane finished or deferred its free during the lag
            retire(inflight)
            inflight = None
        if clock:
            self._read_device_clock(trc, ev0, t_clock0)

        self.stats.preemptions = sched.preemptions
        self.stats.pages_peak = max(self.stats.pages_peak, pool.pages_peak)
        self.stats.cow_copies = pool.cow_copies - cow0
        self.stats.adopt_calls = pool.adopt_calls - adopt0
        self.stats.device_tables_rebuilds = pool.tables_rebuilds - tbl0
        _, cap1, cap_s1 = steps.capture_counters()
        self.stats.graph_captures = cap1 - cap0
        self.stats.capture_s = cap_s1 - cap_s0
        self.stats.graph_replays = steps.replays - replays0
        self.stats.wall_s = time.monotonic() - t0
        self._flush_metrics(reg, admissions)
        if cost0 is not None:
            report = obs_costs.attribute(
                steps, self.stats, cfg=self.cfg, params=self.params,
                page=self.page, kv_dtype_bits=self.cache_dtype.itemsize * 8,
                baseline=cost0)
            self.last_cost_report = report
            obs_costs.flush_metrics(reg, report)
        return requests

    def _read_device_clock(self, trc: obs_trace.Tracer, ev0: int,
                           t0: float) -> None:
        """The traced run's device fields of ``EngineStats``: its device
        spans resolved on the tracer, over the window from ``t0`` (just
        after the clock's anchor) to now; the idle time split by the run's
        host spans (the tracer's events from index ``ev0``)."""
        t0_us, t1_us = trc._ts(t0), trc._ts(time.perf_counter())
        host = [(e["ts"], e["ts"] + e["dur"], e["name"])
                for e in trc.events[ev0:] if e["ph"] == "X"]
        device = [(e["ts"], e["ts"] + e["dur"])
                  for e in trc.resolve_device()]
        s = self.stats
        s.device_window_s = (t1_us - t0_us) * 1e-6
        s.device_busy_s = sum(b - a for a, b in obs_trace.union(
            device, t0_us, t1_us)) * 1e-6
        s.device_idle_s = {k: v * 1e-6 for k, v in obs_trace.idle_by_span(
            host, device, t0_us, t1_us).items()}

    def _flush_metrics(self, reg: obs_metrics.Registry,
                       admissions: Dict[str, int]) -> None:
        """Fold the finished run's EngineStats into the registry (names
        per the ``obs/metrics.py`` contract)."""
        s = self.stats
        reg.counter("serve_rounds_total",
                    "engine rounds that ran a step").inc(s.rounds)
        tok = reg.counter("serve_tokens_total", "tokens emitted/discarded",
                          labels=("kind",))
        tok.inc(s.tokens_out, kind="emitted")
        tok.inc(s.tokens_discarded, kind="discarded")
        adm = reg.counter("serve_admissions_total",
                          "request admissions by prefix-cache outcome",
                          labels=("kind",))
        for kind, n in admissions.items():
            adm.inc(n, kind=kind)
        reg.counter("serve_preemptions_total",
                    "recompute-style slot evictions").inc(s.preemptions)
        ops = reg.counter("serve_page_ops_total",
                          "host<->device page-op round trips",
                          labels=("op",))
        ops.inc(s.adopt_calls, op="adopt")
        ops.inc(s.page_copy_calls, op="page_copy")
        ops.inc(s.device_tables_rebuilds, op="tables_rebuild")
        ops.inc(s.cow_copies, op="cow")
        ops.inc(s.cache_evictions, op="cache_evict")
        ops.inc(s.page_op_flushes, op="fused_flush")
        reg.counter(
            "serve_page_op_round_trips_saved_total",
            "device dispatches avoided by fused page-op batching"
        ).inc(s.page_op_round_trips_saved)
        reg.counter("serve_solo_rounds_total",
                    "rounds run through the B=1 solo-lane step"
                    ).inc(s.solo_rounds)
        pipe = reg.counter("serve_pipeline_rounds_total",
                           "pipelined-loop events by kind",
                           labels=("kind",))
        pipe.inc(s.pipelined_rounds, kind="overlapped")
        pipe.inc(s.pipeline_barriers, kind="barrier")
        reg.counter("serve_pipeline_trimmed_tokens_total",
                    "tokens computed past an EOS during the pipeline "
                    "lag, trimmed and never emitted"
                    ).inc(s.lag_trimmed_tokens)
        reg.gauge("serve_pipeline_overlap_fraction",
                  "fraction of this run's rounds retired through the "
                  "pipeline").set(s.pipeline_overlap)
        reg.counter("serve_speculative_rounds_total",
                    "rounds that carried a speculative verify lane"
                    ).inc(s.spec_rounds)
        spec = reg.counter("serve_speculative_tokens_total",
                           "speculative draft tokens by outcome",
                           labels=("kind",))
        spec.inc(s.spec_draft_tokens, kind="drafted")
        spec.inc(s.spec_accepted_tokens, kind="accepted")
        pool = self._pool
        if pool is not None:
            reg.gauge("serve_pages_used",
                      "arena pages allocated").set(pool.used_count)
            reg.gauge("serve_pages_peak",
                      "peak arena pages this run").set(s.pages_peak)


class LegacyServeEngine:
    """The per-slot baseline (counterpart of the JAX class): batch-1
    contiguous caches, a prefill when a request is seated and one
    ``steps.contiguous_decode`` call per active slot per token, eagerly,
    greedy only. The paged engine is tested against it.

    As in the reference, a request is prefilled from its prompt alone: a
    VLM serves text-only. An encoder-decoder is refused at construction
    (the reference's prefill would fail inside ``encode`` with no
    frames)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, cache_dtype=torch.float32,
                 device="cuda"):
        if cfg.is_encdec:
            raise NotImplementedError(
                "LegacyServeEngine prefills prompts without encoder frames; "
                "serve an encoder-decoder through models.model.prefill / "
                "decode_step")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_to(params, self.device)
        self.slots = slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.stats = EngineStats()
        self._decode = serve_steps.contiguous_decode(cfg)

    def _prefill_one(self, prompt: np.ndarray):
        tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None, :],
                                 device=self.device)
        logits, cache = prefill(self.cfg, self.params, tokens,
                                max_len=self.max_len,
                                cache_dtype=self.cache_dtype)
        self.stats.prefills += 1
        return int(torch.argmax(logits[0])), cache

    def run(self, requests: List[Request],
            greedy: bool = True) -> List[Request]:
        """Process all requests to completion; returns them with outputs.
        Stats describe this run only (a fresh EngineStats per call)."""
        if not greedy:
            raise NotImplementedError("only greedy decoding is implemented")
        self.stats = EngineStats()
        t0 = time.monotonic()
        queue = list(requests)
        active: List[Optional[Request]] = [None] * self.slots
        caches: List = [None] * self.slots
        positions = [0] * self.slots
        next_tok = [0] * self.slots

        def refill() -> None:
            for s in range(self.slots):
                while active[s] is None and queue:
                    req = queue.pop(0)
                    tok, cache = self._prefill_one(req.prompt)
                    req.out_tokens.append(tok)
                    self.stats.tokens_out += 1
                    if _finished(req, len(req.prompt), self.max_len):
                        req.done = True   # EOS at prefill: no decode slot
                        continue
                    active[s] = req
                    caches[s] = cache
                    positions[s] = len(req.prompt)
                    next_tok[s] = tok

        refill()
        while any(a is not None for a in active):
            for s in range(self.slots):
                req = active[s]
                if req is None:
                    continue
                ts = time.monotonic()
                tok = torch.tensor([[next_tok[s]]], dtype=torch.int64,
                                   device=self.device)
                logits, caches[s] = self._decode(self.params, tok,
                                                 caches[s], positions[s])
                positions[s] += 1
                nxt = int(torch.argmax(logits[0]))
                next_tok[s] = nxt
                req.out_tokens.append(nxt)
                self.stats.decode_steps += 1
                self.stats.tokens_out += 1
                self.stats.step_seconds.append(time.monotonic() - ts)
                self.stats.step_tokens.append(1)
                if _finished(req, positions[s], self.max_len):
                    req.done = True
                    active[s] = None
                    caches[s] = None
            refill()
        self.stats.wall_s = time.monotonic() - t0
        return requests
