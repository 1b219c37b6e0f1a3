"""Decode-step traffic model for a model config + quantization scheme.

LLM decode is read-dominated: every generated token streams all active
weights once, plus the KV cache / SSM state, plus (small) activations.
This module turns a ModelConfig + quant method into a byte/bit traffic
breakdown that the memory-system simulator consumes. A copy of
``repro.memsys.workload`` (pure Python); ``pages_for`` and
``chunk_pages_streamed`` are also the rules the port's serving engine
counts pages by.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.qconfig import MXConfig, QMCConfig
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Per-decode-step traffic (bits) and residency (bits / cells)."""
    name: str
    # streamed per token
    weight_bits_outlier: float       # -> MRAM in QMC
    weight_bits_inlier: float        # -> ReRAM in QMC (or DRAM for baselines)
    kv_bits: float                   # -> LPDDR5 always
    act_bits: float                  # -> LPDDR5 always
    # storage
    weight_cells_inlier: float       # MLC cells (capacity accounting)
    weight_cells_outlier: float
    dram_resident_bits: float        # weights resident in DRAM (baselines)
    flash_resident_bits: float       # legacy hierarchy keeps a Flash copy

    @property
    def weight_bits(self) -> float:
        return self.weight_bits_outlier + self.weight_bits_inlier

    @property
    def total_cells(self) -> float:
        return self.weight_cells_inlier + self.weight_cells_outlier


def pages_for(n_tokens: int, page: int) -> int:
    """Pages needed to hold n_tokens (ceil division, min 1).

    Canonical page-granularity rule, shared by the serving allocator
    (``serve/paged_kv.py``) and this traffic model so the two accounts
    cannot drift."""
    return max(1, -(-int(n_tokens) // page))


def kv_bits_per_step(cfg: ModelConfig, seq_len: int, kv_dtype_bits: int = 16
                     ) -> float:
    """KV cache + SSM state bits read per decode step (batch=1)."""
    n_attn = sum(1 for k in cfg.pattern
                 if k.startswith(("attn", "hybrid"))) * cfg.n_groups
    kv = 2.0 * n_attn * cfg.kv_dim * seq_len * kv_dtype_bits
    n_ssm = sum(1 for k in cfg.pattern
                if k == "mamba" or k.startswith("hybrid")) * cfg.n_groups
    ssm = n_ssm * (cfg.ssm_nheads * cfg.ssm_headdim * cfg.d_state * 32
                   + (cfg.d_conv - 1) * cfg.conv_dim * kv_dtype_bits)
    if cfg.is_encdec:
        kv += 2.0 * cfg.n_layers * cfg.kv_dim * cfg.enc_seq * kv_dtype_bits
    return kv + ssm


def act_bits_per_step(cfg: ModelConfig, act_dtype_bits: int = 16) -> float:
    return 4.0 * cfg.n_layers * cfg.d_model * act_dtype_bits


@dataclasses.dataclass(frozen=True)
class PagedKVTraffic:
    """Batch-dependent KV stream under the paged serving pool.

    A block-table-aware attention kernel streams *whole live pages*, so
    per-step traffic is page-rounded; residency counts allocated pages, so
    pool sizing sees internal fragmentation explicitly. ``exact`` fields
    are the contiguous (unpadded) equivalents for comparison. The Pallas
    decode kernel (``kernels/paged_attention.py``) gathers exactly the
    ``live_only=True`` stream; ``live_only=False`` models the XLA
    reference gather's full-block-table reads instead."""
    page: int
    n_seqs: int
    n_pages: int                     # allocated across the batch
    kv_bits_per_step: float          # page-rounded, summed over the batch
    kv_bits_per_step_exact: float    # contiguous equivalent
    resident_bits: float             # pool bytes held by the batch
    resident_bits_exact: float

    @property
    def frag_bits_per_step(self) -> float:
        return self.kv_bits_per_step - self.kv_bits_per_step_exact

    @property
    def utilization(self) -> float:
        """Fraction of allocated pool bits holding live tokens."""
        return (self.resident_bits_exact / self.resident_bits
                if self.resident_bits else 1.0)

    def apply(self, traffic: "Traffic") -> "Traffic":
        """Rebind a single-sequence Traffic to this batch's KV stream —

        the hook that lets the §4 DSE (Eq. 3 latency / Eq. 4 power) score a
        memory system under batched paged serving instead of the paper's
        batch-1 assumption."""
        return dataclasses.replace(
            traffic, name=f"{traffic.name}+paged_b{self.n_seqs}",
            kv_bits=self.kv_bits_per_step)


def kv_traffic_paged(cfg: ModelConfig, seq_lens, *, page: int = 16,
                     kv_dtype_bits: int = 16, live_only: bool = True,
                     max_pages_per_seq: Optional[int] = None
                     ) -> PagedKVTraffic:
    """KV traffic/residency for a batch of sequences in the paged pool.

    ``seq_lens`` are the current lengths (prompt + generated so far) of the
    active sequences; each contributes ceil(len/page) pages. SSM state (the
    O(1) part of ``kv_bits_per_step``) is per-slot dense and not paged.

    ``live_only=True`` (default) charges the stream the page-table-aware
    Pallas kernel (``kernels/paged_attention.py``) actually gathers —
    live pages only, byte-for-byte (the DSE-vs-implementation contract
    pinned by ``tests/test_memsys.py``). ``live_only=False`` widens the
    per-step STREAM to the full block-table width (``max_pages_per_seq``
    pages per lane, required then) — what the XLA reference gather in
    ``models/attention.py`` materializes; the gap between the two is the
    dead-page bandwidth the kernel saves. Residency fields
    (``n_pages``/``resident_bits``/``utilization``) always describe the
    live allocation — the gather path never changes what the pool holds.
    """
    seq_lens = list(seq_lens)
    if not live_only and max_pages_per_seq is None:
        raise ValueError("live_only=False (full-width gather) needs "
                         "max_pages_per_seq, the block-table width")
    n_pages = 0
    live_bits = bits = bits_exact = 0.0
    for length in seq_lens:
        p = pages_for(length, page)
        n_pages += p
        live_bits += kv_bits_per_step(cfg, p * page, kv_dtype_bits)
        bits += kv_bits_per_step(
            cfg, (p if live_only else max_pages_per_seq) * page,
            kv_dtype_bits)
        bits_exact += kv_bits_per_step(cfg, int(length), kv_dtype_bits)
    # residency: decode streams the whole live cache each step, so one
    # step's LIVE stream IS the resident KV at these lengths
    return PagedKVTraffic(page=page, n_seqs=len(seq_lens),
                          n_pages=n_pages, kv_bits_per_step=bits,
                          kv_bits_per_step_exact=bits_exact,
                          resident_bits=live_bits,
                          resident_bits_exact=bits_exact)


def chunk_pages_streamed(q_start: int, n_new: int, *, page: int = 16,
                         q_block: int = 16) -> int:
    """Live pages the ragged paged-attention kernel streams for one chunk.

    Host-side mirror of the kernel's BlockSpec index map
    (``kernels/paged_attention.py``): a chunk of ``n_new`` query tokens at
    absolute positions ``q_start + t`` runs as ``ceil(n_new/q_block)`` q
    blocks, and block ``qb`` fetches exactly the pages causally visible
    to it — ``p * page < min(q_start + n_new, q_start + (qb+1)*q_block)``.
    Decode (``n_new == 1``) collapses to ``ceil((q_start+1)/page)``. The
    canonical page-granularity rule for chunk traffic, shared by the
    engine's ``prefill_kv_pages_live`` counter and
    :func:`kv_traffic_chunked` so the two accounts cannot drift."""
    q_start, n_new = int(q_start), int(n_new)
    if n_new <= 0:
        return 0
    kv_len = q_start + n_new
    total = 0
    for qb in range(-(-n_new // q_block)):
        limit = min(kv_len, q_start + (qb + 1) * q_block)
        total += -(-limit // page)
    return total


@dataclasses.dataclass(frozen=True)
class ChunkedPrefillTraffic:
    """KV traffic of one prompt's chunked prefill through the ragged path.

    Chunked prefill scatters each chunk's K/V into the arena (page-rounded
    **writes**) and then attends causally over everything written so far
    (**reads**, streamed per q block by the kernel — the online-softmax
    restream is quadratic in prompt length either way, so chunking leaves
    total read traffic within one chunk-boundary rounding of monolithic;
    what it buys is TTFT/ITL, which the serving benchmark measures). All
    counts are whole pages so the Eq. (3)/(4) DSE charges exactly what the
    engine's ``prefill_kv_pages_live`` / ``prefill_kv_pages_written``
    counters record — pinned page-for-page by ``tests/test_memsys.py``."""
    page: int
    chunk: int
    q_block: int
    n_chunks: int
    kv_pages_read: int               # live pages streamed across chunks
    kv_pages_written: int            # pages touched by chunk K/V writes
    kv_pages_read_monolithic: int    # one-shot (single chunk) equivalent
    kv_read_bits: float
    kv_write_bits: float

    def apply(self, traffic: "Traffic",
              amortize_tokens: int) -> "Traffic":
        """Rebind a Traffic's KV stream for the Eq. (3)/(4) DSE: the
        prefill's page reads+writes are spread over ``amortize_tokens``
        generated tokens and added to the per-step KV bits."""
        kv = traffic.kv_bits + ((self.kv_read_bits + self.kv_write_bits)
                                / amortize_tokens)
        return dataclasses.replace(
            traffic, name=f"{traffic.name}+chunked_c{self.chunk}",
            kv_bits=kv)


def kv_traffic_chunked(cfg: ModelConfig, prompt_len: int, *, chunk: int,
                       page: int = 16, q_block: int = 16,
                       cached_len: int = 0,
                       kv_dtype_bits: int = 16) -> ChunkedPrefillTraffic:
    """KV traffic for prefilling one prompt in fixed-size chunks.

    ``cached_len`` prompt tokens (whole pages) are served from adopted
    prefix-cache pages: they are neither re-written nor re-chunked, but
    later chunks still stream them as causal context. Chunk boundaries
    follow the engine's scheduler: ``cached_len``, ``cached_len+chunk``,
    ... (the last chunk is the remainder)."""
    prompt_len, cached_len = int(prompt_len), int(cached_len)
    if cached_len % page or cached_len > prompt_len:
        raise ValueError(
            f"cached length {cached_len} must be whole pages <= prompt "
            f"{prompt_len}")
    start = min(cached_len, prompt_len - 1) if prompt_len else 0

    def kv_token_bits(n_tokens: int) -> float:
        return (kv_bits_per_step(cfg, n_tokens, kv_dtype_bits)
                - kv_bits_per_step(cfg, 0, kv_dtype_bits))

    def sweep(width: int):
        reads = writes = n_chunks = 0
        s0 = start
        while s0 < prompt_len:
            n = min(width, prompt_len - s0)
            reads += chunk_pages_streamed(s0, n, page=page,
                                          q_block=q_block)
            writes += -(-(s0 + n) // page) - s0 // page
            n_chunks += 1
            s0 += n
        return reads, writes, n_chunks

    reads, writes, n_chunks = sweep(chunk)
    mono_reads, _, _ = sweep(max(prompt_len - start, 1))
    per_page = kv_token_bits(page)
    return ChunkedPrefillTraffic(
        page=page, chunk=chunk, q_block=q_block, n_chunks=n_chunks,
        kv_pages_read=reads, kv_pages_written=writes,
        kv_pages_read_monolithic=mono_reads,
        kv_read_bits=reads * per_page,
        kv_write_bits=writes * per_page)


@dataclasses.dataclass(frozen=True)
class PrefixKVTraffic:
    """Batched KV stream when prompt prefixes are served from cached pages.

    Two effects of the prefix cache (``serve/prefix_cache.py``) reach the
    memory system:

      * **Prefill writes disappear for hit pages** — a cached page is
        adopted by block-table aliasing, so its KV is never recomputed and
        never re-written over LPDDR5. ``prefill_write_bits`` charges only
        the uncached suffix pages (page-rounded, matching the pool's
        allocation granule); ``_nocache`` is the same batch without the
        cache.
      * **Residency dedups shared pages** — one physical page serves every
        sequence that aliases it, so the pool holds
        ``private + unique-shared`` pages, not the sum of per-sequence
        footprints.

    Decode *reads* do not change: every sequence still streams its whole
    mapped table each step (shared pages are re-read per sequence), so
    ``kv_bits_per_step`` equals the plain paged model's."""
    page: int
    n_seqs: int
    n_pages: int                      # physical pages held (dedup'd)
    n_pages_nocache: int              # sum of per-seq footprints
    hit_rate: float                   # cached / total prompt tokens
    prefill_write_bits: float         # KV written during prefill, with cache
    prefill_write_bits_nocache: float
    kv_bits_per_step: float           # decode stream (same as paged)
    resident_bits: float              # pool bits held (dedup'd)
    resident_bits_nocache: float

    @property
    def saved_prefill_write_bits(self) -> float:
        return self.prefill_write_bits_nocache - self.prefill_write_bits

    @property
    def saved_resident_bits(self) -> float:
        return self.resident_bits_nocache - self.resident_bits

    def apply(self, traffic: "Traffic",
              amortize_tokens: Optional[int] = None) -> "Traffic":
        """Rebind a Traffic's KV stream to this batch for the Eq. (3)/(4)
        DSE. With ``amortize_tokens`` (expected decode tokens per request)
        the per-request prefill writes the cache did NOT save are spread
        over the generated tokens and added to the per-step KV bits, so
        the DSE sees prefill traffic shrink with the hit rate."""
        kv = self.kv_bits_per_step
        if amortize_tokens:
            kv += self.prefill_write_bits / (self.n_seqs * amortize_tokens)
        return dataclasses.replace(
            traffic, name=f"{traffic.name}+prefix_b{self.n_seqs}",
            kv_bits=kv)


def kv_traffic_prefix(cfg: ModelConfig, prompt_lens, cached_lens,
                      seq_lens=None, *, unique_cached_tokens=None,
                      page: int = 16,
                      kv_dtype_bits: int = 16) -> PrefixKVTraffic:
    """KV traffic/residency for a batch whose prompts hit the prefix cache.

    ``prompt_lens[i]`` is sequence i's prompt length; ``cached_lens[i]``
    how many of those tokens were served from cached pages (whole pages,
    so a multiple of ``page``; 0 = miss). ``seq_lens`` are current total
    lengths for the decode stream (default: the prompts, i.e. step 1).
    ``unique_cached_tokens`` is the number of distinct cached tokens the
    hits alias (default: the longest cached prefix — the single shared
    system prompt case); sharing dedups residency but never decode reads.

    Sequences are *consumers* of the shared set. A publisher whose pages
    became the cached copy should be listed with its prefix as cached
    (its footprint IS the shared set) when computing residency — listing
    it as a miss charges those pages both privately and as shared. For
    prefill-write accounting the opposite holds: the publisher really
    wrote every page, so list it as a miss there (see
    ``benchmarks/serving.py`` for the two views side by side).
    """
    prompt_lens = [int(x) for x in prompt_lens]
    cached_lens = [int(x) for x in cached_lens]
    if len(prompt_lens) != len(cached_lens):
        raise ValueError("prompt_lens and cached_lens must align")
    for lp, lc in zip(prompt_lens, cached_lens):
        if lc % page or lc > lp:
            raise ValueError(
                f"cached length {lc} must be whole pages <= prompt {lp}")
    seq_lens = ([int(x) for x in seq_lens] if seq_lens is not None
                else prompt_lens)
    if unique_cached_tokens is None:
        unique_cached_tokens = max(cached_lens, default=0)

    def kv_token_bits(n_tokens: int) -> float:
        """Sequence-length-dependent KV bits (excludes O(1) SSM state)."""
        return (kv_bits_per_step(cfg, n_tokens, kv_dtype_bits)
                - kv_bits_per_step(cfg, 0, kv_dtype_bits))

    write = write_nocache = 0.0
    pages = pages_nocache = 0
    for lp, lc in zip(prompt_lens, cached_lens):
        full = pages_for(lp, page)
        pages_nocache += full
        pages += full - lc // page
        # prefill writes are page-rounded like the allocator's granule
        write += kv_token_bits(full * page - lc)
        write_nocache += kv_token_bits(full * page)
    shared_pages = pages_for(unique_cached_tokens, page) \
        if unique_cached_tokens else 0
    pages += shared_pages
    paged = kv_traffic_paged(cfg, seq_lens, page=page,
                             kv_dtype_bits=kv_dtype_bits)
    total_prompt = sum(prompt_lens)
    return PrefixKVTraffic(
        page=page, n_seqs=len(prompt_lens), n_pages=pages,
        n_pages_nocache=pages_nocache,
        hit_rate=(sum(cached_lens) / total_prompt if total_prompt else 0.0),
        prefill_write_bits=write,
        prefill_write_bits_nocache=write_nocache,
        kv_bits_per_step=paged.kv_bits_per_step,
        resident_bits=pages * kv_token_bits(page),
        resident_bits_nocache=pages_nocache * kv_token_bits(page))


@dataclasses.dataclass(frozen=True)
class ShardedServeTraffic:
    """Per-device traffic under the sharded serving step set.

    The sharded paged engine (``serve/steps.py``) splits the byte streams
    the Eq. (3)/(4) DSE charges:

      * **weights** — TP over ``model``: every device streams only its
        shard's quantized streams (``ShardedQTensor`` stacks are
        quantize-after-shard, so shard streams are equal-sized by
        construction); the ``data`` axis replicates weights at inference.
      * **KV** — the arena's page axis shards over ``data`` and the fused
        kv_dim over ``model``: a device streams its slice of each live
        page, i.e. ``1/(data*model)`` of the batch KV stream.
      * **activations** — batch shards over ``data`` (each device decodes
        its slot slice); the hidden dim stays replicated.

    ``apply`` rebinds a single-device :class:`Traffic` to the per-device
    streams so the memory-system DSE scores ONE shard of the mesh — the
    unit that actually owns an eMEM/LPDDR5 stack on a multi-device edge
    board (SLIM-style heterogeneous partitioning)."""
    data_shards: int = 1
    model_shards: int = 1

    @property
    def n_devices(self) -> int:
        return self.data_shards * self.model_shards

    def apply(self, traffic: "Traffic") -> "Traffic":
        d, m = self.data_shards, self.model_shards
        return dataclasses.replace(
            traffic,
            name=f"{traffic.name}+shard_d{d}m{m}",
            weight_bits_outlier=traffic.weight_bits_outlier / m,
            weight_bits_inlier=traffic.weight_bits_inlier / m,
            kv_bits=traffic.kv_bits / (d * m),
            act_bits=traffic.act_bits / d,
            weight_cells_inlier=traffic.weight_cells_inlier / m,
            weight_cells_outlier=traffic.weight_cells_outlier / m,
            dram_resident_bits=traffic.dram_resident_bits / m,
            flash_resident_bits=traffic.flash_resident_bits / m)


def shard_serve_traffic(traffic: Traffic, *, data_shards: int = 1,
                        model_shards: int = 1) -> Traffic:
    """One-shot convenience: per-device view of ``traffic`` on a
    (data, model) serving mesh."""
    return ShardedServeTraffic(data_shards=data_shards,
                               model_shards=model_shards).apply(traffic)


def make_traffic(cfg: ModelConfig, method: str, *, seq_len: int = 2048,
                 qmc: QMCConfig = QMCConfig(), mx: MXConfig = MXConfig(),
                 legacy_flash: bool = False) -> Traffic:
    """Traffic for one decode step under a quantization scheme.

    Methods: fp32 | fp16 | rtn4 | awq | gptq | mx4 -> homogeneous weights
             in DRAM (fp32 is the unquantized serving baseline the cost-
             attribution layer compares QMC against).
             qmc -> dual-precision split across MRAM/ReRAM.
             emems_mram / emems_reram -> homogeneous INT4 in a single NVM.
    """
    n_active = cfg.active_param_count()
    kv = kv_bits_per_step(cfg, seq_len)
    act = act_bits_per_step(cfg)

    if method in ("fp32", "fp16", "rtn4", "awq", "gptq", "mx4"):
        bits = {"fp32": 32.0, "fp16": 16.0, "rtn4": 4.0, "awq": 4.0,
                "gptq": 4.0, "mx4": mx.avg_bits}[method]
        wbits = n_active * bits
        return Traffic(name=method, weight_bits_outlier=0.0,
                       weight_bits_inlier=wbits, kv_bits=kv, act_bits=act,
                       weight_cells_inlier=cfg.param_count() * bits,
                       weight_cells_outlier=0.0,
                       dram_resident_bits=cfg.param_count() * bits,
                       flash_resident_bits=(cfg.param_count() * bits
                                            if legacy_flash else 0.0))

    if method == "qmc":
        rho = qmc.rho
        out_bits = n_active * rho * qmc.bits_out
        in_bits = n_active * (1 - rho) * qmc.bits_in
        # capacity: inliers live in MLC cells (bits_in / cell_bits cells per
        # weight), outliers in (1-bit) MRAM cells
        in_cells = cfg.param_count() * (1 - rho) * qmc.bits_in \
            / qmc.cell_bits
        out_cells = cfg.param_count() * rho * qmc.bits_out
        return Traffic(name=f"qmc{qmc.cell_bits}b",
                       weight_bits_outlier=out_bits,
                       weight_bits_inlier=in_bits, kv_bits=kv, act_bits=act,
                       weight_cells_inlier=in_cells,
                       weight_cells_outlier=out_cells,
                       dram_resident_bits=0.0, flash_resident_bits=0.0)

    if method in ("emems_mram", "emems_reram"):
        wbits = n_active * 4.0
        if method == "emems_mram":
            return Traffic(name=method, weight_bits_outlier=wbits,
                           weight_bits_inlier=0.0, kv_bits=kv, act_bits=act,
                           weight_cells_inlier=0.0,
                           weight_cells_outlier=cfg.param_count() * 4.0,
                           dram_resident_bits=0.0, flash_resident_bits=0.0)
        return Traffic(name=method, weight_bits_outlier=0.0,
                       weight_bits_inlier=wbits, kv_bits=kv, act_bits=act,
                       weight_cells_inlier=cfg.param_count() * 4.0 / 3.0,
                       weight_cells_outlier=0.0,
                       dram_resident_bits=0.0, flash_resident_bits=0.0)
    raise ValueError(method)
