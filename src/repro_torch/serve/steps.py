"""The paged serving step set (counterpart of ``repro.serve.steps``).

  ``step(cfg, params, tokens [B, C], arena, start [B], n_new [B], samp)
  -> (tokens [B, C] int32, logprobs [B, C] float32)``

Lane ``b`` runs ``n_new[b]`` new tokens at absolute positions ``start[b]
+ t``: a decode lane carries one token (or ``1 + k`` on a speculative
verify round), a prefill lane a chunk of its prompt, an idle lane ``n_new
= 0`` (its writes route to the null page and its output columns are
dead). K/V scatter into the arena (in place) and the ragged attention
read happen in the one call; token selection
(``serve.sampling.select_tokens``, with the lane params ``samp`` =
``{"temp", "top_k", "top_p", "key"}``) runs on the card, so only ``[B,
C]`` ids and logprobs leave it. ``solo_step`` is the same step at batch
width 1 for lane ``slot`` of the arena; ``apply_page_ops`` is a round's
page maintenance: the copy-on-write page copies of the prefix cache, the
block-table upload into every group, and, on mamba and hybrid stacks, the
zeroing of freshly seated slots' SSM and conv rows, all in place. The
recurrent state of those stacks lives dense per slot beside the pages; an
idle lane (``n_new = 0``) leaves it bit for bit as it was.

``contiguous_decode(cfg)`` is the legacy per-slot engine's executable:
one token on a batch-1 contiguous cache (``models.model.decode_step``),
a plain callable run eagerly. ``build_prefill`` / ``build_decode`` are
the contiguous prefill and decode on a rank mesh (as in JAX, where the
dry-run cells lower them and they serve encoder-decoder and VLM stacks
sharded): each returns a function that a rank calls eagerly on its
parameter slices, its rows of the batch and its cache (``launch.
sharding.local_cache``, ``cache_spec``); ``logits2d`` is their logits'
spec and ``gather_logits`` makes the whole ``[B, V]`` over the mesh.

These are plain functions. ``build_paged_steps`` wraps them into the step
set one engine runs, :class:`PagedServeSteps`, the counterpart of the JAX
package's per-width jit: its ``step`` and ``solo_step`` hold up to two
``torch.cuda.CUDAGraph`` per token width ``C`` in ``{1} + width_ladder
(chunk)`` (the declared widths), captured at the first use of ``C`` into
one memory pool that all widths share: one whose head runs the sampled
branch, taken when a live lane samples, and one whose head is greedy
only, taken otherwise (the host knows each lane's temperature, so the
choice reads nothing from the device; an all-greedy round gives the same
tokens either way, and never pays for the sampled branch). A replay
copies the round's inputs into the width's static buffers (one upload
from pinned memory), replays and returns the static outputs, valid until
the next call at that width.
The graphs read the parameters and the arena they were captured with, by
address: a call with another parameter tree or arena drops them and
captures anew, so no graph ever replays against freed memory; the arena
is only ever written in place. On a CPU tensor (``device="cpu"``) the same
wrapper runs the body eagerly on its static buffers, and on the card
``cuda_graphs=False`` does so too (a switch to compare against, not a
fallback: a failed capture raises).

The mesh step set (``build_paged_steps(..., mesh=...)``, built like the
JAX one): every step runs under ``runtime_context.use_mesh`` with the
rank's page slice, so the model is tensor-parallel over ``model`` and
attention reads the rank's pages and merges over ``data``; the head
selects over vocab shards (``sampling.select_tokens_tp``). Its batch
follows JAX's ``batch_spec`` over ``max_slots`` (``launch.sharding.
serve_rows``, ``PagedServeSteps.rows``): where the slots divide the data
axis, data rank ``k`` runs lanes ``[k B / D, (k + 1) B / D)`` through
every layer outside attention and through the head, each attention layer
gathers its lanes' ``q | k | v`` over ``data`` (kind ``rows``) and runs
every lane over its page slice, and the lanes' tokens go to every rank
in one all_gather (kind ``tokens``); where they do not, every rank runs
every lane. It has no
solo lane (``solo_step`` is None, as JAX's is under a mesh), and it runs
eagerly: ``cuda_graphs=False`` must be passed, because gloo collectives
cannot be captured (and NCCL inside a graph waits for a host with one
card per rank). Its page ops copy a COW page whose source and
destination sit on different data ranks with one all_reduce SUM over the
data group (every page copy of the call packed into one int32 buffer, the
source rank's bytes and zeros elsewhere: exact). The pipelined loop and
speculative decode run on it unchanged (they only call the step and
read the gathered tokens). Its page ops zero a reseated slot's SSM and
conv rows on the rank that holds them (every rank where the lanes are
not split), as its ``reset_state`` does.

Kernel launch tallies (``kernels.build.launches``, ``kernels.ops.
path_counts``) are Python counters that a replay does not move: each
graph records the tallies of its capture and adds them on every replay.

Observability (the counterpart of the JAX package's ``TracedJit``): a
graph captured for a new (width, head) pair on the card, or a width's
buffers created on the CPU or with ``cuda_graphs=False``, is the port's
compile. It fires a ``jit/compile`` instant (fn, width, seconds) on the
process tracer and increments ``serve_jit_compiles_total{fn}`` on the
process registry; growth past the declared ``surface`` also fires
``jit/unexpected_retrace`` and ``serve_jit_retraces_unexpected_total
{fn}`` (it never raises). With ``obs.costs`` capture on, every ``step``,
``solo_step`` and ``apply_page_ops`` call lands in ``calls_by_key``,
``seconds_by_key`` and ``cost_by_key`` (keyed ``C<width>``, and
``call`` for the page ops, which have no count): the timed window closes
with ``torch.cuda.synchronize()`` after the replay, the warm-up and
capture of a call that captures are left out of it (``capture_seconds``
holds the capture), and each call adds to the ``cost/<fn>`` counter track
of the process tracer. None of it runs inside a capture.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import runtime_context as ctx
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shd
from repro_torch.models import kvcache as KV
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, forward, prefill
from repro_torch.obs import costs as obs_costs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.sampling import select_tokens, select_tokens_tp
from repro_torch.serve.scheduler import bucket_len


def width_ladder(chunk: int) -> tuple:
    """Step widths ``C > 1``: pow2 rungs from 4 up to ``chunk``. A short
    prefill chunk runs at the smallest rung that covers it."""
    if chunk <= 1:
        return ()
    w, out = 4, []
    while w < chunk:
        out.append(w)
        w *= 2
    out.append(chunk)
    return tuple(out)


def default_chunk(max_pages_per_seq: int, page: int) -> int:
    """Default prefill chunk width: the pow2 that covers the longest
    admissible sequence (every prompt is one chunk)."""
    return bucket_len(max_pages_per_seq * page, page)


def default_n_pages(slots: int, max_pages_per_seq: int, mesh=None) -> int:
    """Default pool size: every slot at full length, rounded up so that
    the arena's page count (usable pages + the null page) divides the
    mesh's ``data`` axis."""
    n = slots * max_pages_per_seq
    d = meshlib.axis_size(mesh, "data") if mesh is not None else 1
    if d > 1:
        n += (-(n + 1)) % d
    return n


def step(cfg: ModelConfig, params: dict, tokens: torch.Tensor, arena: dict,
         start: torch.Tensor, n_new: torch.Tensor,
         samp: Dict[str, torch.Tensor], *, sampled: bool = True,
         use_kernels: bool = True, paged_attention: bool = True,
         rows: Optional[slice] = None):
    """The ONE serving step: ragged chunked prefill + batched decode.
    ``samp`` holds the lane params ``temp``, ``top_k``, ``top_p`` [B] and
    ``key`` [B, 2] (int32 holding uint32 bits); ``sampled=False`` promises
    that no lane samples (``select_tokens``).

    ``rows`` (a rank of the mesh step set whose lanes are split over
    ``data``, ``launch.sharding.serve_rows``) runs only those lanes
    through the model and the head, each with its own ``samp`` row, while
    attention reads every lane's positions and ``valid_len``
    (``runtime_context.current_lanes``); the lanes' tokens and logprobs
    then go to every rank in one all_gather over ``data`` (kind
    ``tokens``), so the host loop reads every lane's."""
    c = tokens.shape[1]
    positions = start[:, None] + torch.arange(
        c, dtype=start.dtype, device=start.device)[None, :]
    valid = start + n_new
    if rows is not None:
        mesh = ctx.current_mesh()
        with ctx.use_mesh(mesh, ctx.current_dp(), ctx.current_page_slice(),
                          split_rows=True, lanes=(positions, valid)):
            tok, logp = step(cfg, params, tokens[rows], arena, start[rows],
                             n_new[rows], {k: v[rows]
                                           for k, v in samp.items()},
                             sampled=sampled, use_kernels=use_kernels,
                             paged_attention=paged_attention)
        packed = torch.stack([tok, logp.view(torch.int32)], dim=-1)
        packed = mesh.all_gather(packed.contiguous(), "data", 0,
                                 kind="tokens")
        return packed[..., 0], packed[..., 1].contiguous().view(
            torch.float32)
    logits = forward(cfg, params, tokens, positions=positions, cache=arena,
                     valid_len=valid, use_kernels=use_kernels,
                     paged_attention=paged_attention)
    if logits.shape[-1] != cfg.vocab:        # a vocab-parallel head
        return select_tokens_tp(logits, cfg.vocab, samp["temp"],
                                samp["top_k"], samp["top_p"], samp["key"],
                                positions, n_new, ctx.current_mesh(),
                                sampled=sampled)
    return select_tokens(logits, samp["temp"], samp["top_k"], samp["top_p"],
                         samp["key"], positions, n_new, sampled=sampled)


def solo_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
              arena: dict, slot: torch.Tensor, start: torch.Tensor,
              n_new: torch.Tensor, samp: Dict[str, torch.Tensor], *,
              sampled: bool = True, use_kernels: bool = True,
              paged_attention: bool = True):
    """The step at batch width 1 on lane ``slot`` (a one-element tensor)
    of the arena: ``tokens [1, C]``, ``start``, ``n_new`` [1] and ``samp``
    of one lane (counterpart of ``_solo_step_body``).
    Lane ``slot``'s block-table row is selected on the device into a
    ``[G, 1, P]`` view; the page leaves are the arena's own, so K/V land
    in the global pages directly. Its SSM and conv rows are selected the
    same way and written back in place after the step."""
    idx = slot.to(torch.int64)
    view = {}
    for key, grp in arena.items():
        view[key] = {}
        if "attn" in grp:
            attn = dict(grp["attn"])
            attn["block_tbl"] = torch.index_select(attn["block_tbl"], 1,
                                                   idx)
            view[key]["attn"] = attn
        if "mamba" in grp:
            view[key]["mamba"] = {
                name: torch.index_select(leaf, 1, idx)
                for name, leaf in grp["mamba"].items()}
    out = step(cfg, params, tokens, view, start, n_new, samp,
               sampled=sampled, use_kernels=use_kernels,
               paged_attention=paged_attention)
    for key, grp in arena.items():
        if "mamba" in grp:
            for name, leaf in grp["mamba"].items():
                leaf.index_copy_(1, idx, view[key]["mamba"][name])
    return out


def apply_page_ops(arena: dict, tables: torch.Tensor,
                   copy_src: Optional[torch.Tensor] = None,
                   copy_dst: Optional[torch.Tensor] = None,
                   reset: Optional[torch.Tensor] = None, mesh=None,
                   page_slice: Optional[Tuple[int, int]] = None,
                   rows: Optional[slice] = None) -> dict:
    """One round's page maintenance, in place (counterpart of
    ``_apply_page_ops_body``): page ``copy_dst[i]`` of every page leaf
    becomes a copy of page ``copy_src[i]`` (the device half of
    ``PagedKVPool.cow``; unused entries are padded with 0 -> 0 null-page
    self-copies, as the JAX engine pads them), then ``tables [S, P]`` is
    written into every group's ``block_tbl``, and the SSM and conv rows of
    the slots where ``reset [S]`` is nonzero (freshly seated) are zeroed.
    Groups without attention have no pages or table. In place because the
    step set's graphs read the arena by address. With a ``page_slice``
    (a rank of a mesh whose data axis is over 1) the page ids are global
    and the copies cross ranks (``_copy_pages_across``); with ``rows``
    (the rank's lanes of a row split) the arena holds only those slots'
    SSM and conv rows, and ``reset``'s entries for them apply."""
    if copy_src is not None and page_slice is not None:
        _copy_pages_across(arena, copy_src, copy_dst, mesh, page_slice)
        copy_src = None
    for grp in arena.values():
        if "attn" in grp:
            attn = grp["attn"]
            if copy_src is not None:
                src = copy_src.to(torch.int64)
                dst = copy_dst.to(torch.int64)
                for name, leaf in attn.items():
                    if name.endswith("_pages"):
                        leaf.index_copy_(1, dst, leaf.index_select(1, src))
            tbl = attn["block_tbl"]
            tbl.copy_(tables.to(torch.int32)[None].expand_as(tbl))
        if "mamba" in grp and reset is not None:
            own = reset if rows is None else reset[rows]
            for leaf in grp["mamba"].values():
                mask = (own != 0).view((1, -1) + (1,) * (leaf.dim() - 2))
                leaf.masked_fill_(mask, 0)
    return arena


def _copy_pages_across(arena: dict, copy_src: torch.Tensor,
                       copy_dst: torch.Tensor, mesh,
                       page_slice: Tuple[int, int]) -> None:
    """Page copies ``src -> dst`` (global ids) over the data ranks' page
    slices: the rank holding ``src`` puts its bytes (every page leaf of
    every group) in one buffer, the others zeros; one all_reduce SUM over
    the data group, on the buffer's int32 view, gives every rank the
    source's bytes exactly; the rank holding ``dst`` writes them, the
    others write their sink page."""
    first, n = page_slice
    src = copy_src.to(torch.int64) - first
    dst = copy_dst.to(torch.int64) - first
    own_src = (src >= 0) & (src < n)
    own_dst = (dst >= 0) & (dst < n)
    src = torch.where(own_src, src, torch.zeros_like(src))
    dst = torch.where(own_dst, dst, torch.full_like(dst, n))
    leaves = [leaf for grp in arena.values() if "attn" in grp
              for name, leaf in grp["attn"].items()
              if name.endswith("_pages")]
    parts, sizes = [], []
    for leaf in leaves:
        x = leaf.index_select(1, src)                 # [G, S, page, X]
        x = torch.where(own_src.view(1, -1, 1, 1), x, torch.zeros_like(x))
        x = x.contiguous().view(torch.uint8).reshape(-1)
        sizes.append(x.numel())
        parts += [x, x.new_zeros((-x.numel()) % 16)]  # 16-byte aligned
    flat = torch.cat(parts)
    mesh.all_reduce(flat.view(torch.int32), "data", kind="pages")
    o = 0
    for leaf, size in zip(leaves, sizes):
        shape = (leaf.shape[0], src.numel()) + tuple(leaf.shape[2:])
        x = flat[o:o + size].view(leaf.dtype).view(shape)
        leaf.index_copy_(1, dst, x)
        o += size + (-size) % 16


def reset_state(arena: dict, slot: int, rows: Optional[slice] = None
                ) -> dict:
    """Zero lane ``slot``'s SSM and conv rows in every group, in place
    (counterpart of ``_reset_state_body``): a freshly seated slot's
    recurrent state starts from zero, whatever its previous occupant
    left. The engine folds resets into ``apply_page_ops``; this is the
    one-slot form the step set exposes, as JAX's does. With ``rows`` (the
    rank's lanes of a row split, whose rows alone the arena holds) only
    the rank that holds ``slot`` zeroes it, at its local row."""
    if rows is not None:
        if not rows.start <= slot < rows.stop:
            return arena
        slot -= rows.start
    for grp in arena.values():
        if "mamba" in grp:
            for leaf in grp["mamba"].values():
                leaf[:, slot].zero_()
    return arena


def carry_decode_tokens(prev_tok: torch.Tensor, slot: Optional[int] = None
                        ) -> torch.Tensor:
    """The previous C = 1 round's selected tokens on the device, as the
    next dispatch's token input (counterpart of the JAX function): the
    step set copies them into its static input from device to device, so
    pipelined decode tokens never pass through the host. ``slot=None``
    keeps the batch ``[B, 1]`` (dead lanes carry ``DEAD_TOKEN`` and are
    masked by ``n_new = 0``); ``slot`` takes lane ``slot``'s row for a
    ``solo_step`` dispatch, and a ``[1, 1]`` solo output passes through.
    The result has the shape of the host tokens of the same width, so the
    carry adds no width."""
    if slot is None or prev_tok.shape[0] == 1:
        return prev_tok
    return prev_tok[slot:slot + 1]


def contiguous_decode(cfg: ModelConfig) -> Callable:
    """``fn(params, token [B, 1], cache, pos) -> (logits [B, V], cache)``:
    one contiguous decode step, eager (the JAX counterpart jits it once
    per ModelConfig; there is nothing here to keep per config)."""
    return functools.partial(decode_step, cfg)


# ---------------------------------------------------------------------------
# the contiguous prefill and decode on a rank mesh (JAX
# ``serve/steps.py:145-217``)
# ---------------------------------------------------------------------------
def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16) -> dict:
    """The whole contiguous cache's shapes and dtypes (``device="meta"``;
    a rank's: ``launch.sharding.local_cache`` on ``meta``)."""
    if cfg.is_encdec:
        return {"b0": KV.init_encdec_cache(cfg, batch, max_len, dtype,
                                           "meta")}
    return KV.init_cache(cfg, batch, max_len, dtype, "meta")


def _mesh_context(mesh, batch: int, cache_len: int):
    """``use_mesh`` for a contiguous call: the rows split over the dp axes
    when the global batch divides them (an MoE block's capacity is then
    global over the dp ranks' rows, as JAX's jit over the global batch
    has it), else every dp rank runs every row and holds its sequence cut
    of the cache (``launch.sharding.seq_slice``: attention merges the
    data ranks' slices)."""
    return ctx.use_mesh(mesh, meshlib.dp_axes(mesh),
                        split_rows=bool(shd.batch_spec(mesh, batch)),
                        seq_slice=shd.seq_slice(mesh, batch, cache_len))


def build_prefill(cfg: ModelConfig, mesh, *, batch: int, seq: int,
                  cache_len: Optional[int] = None,
                  cache_dtype=torch.bfloat16,
                  use_kernels: bool = True) -> Callable:
    """``fn(params, tokens, extras, cache=None) -> (last_logits, cache)``
    on one rank of ``mesh`` (JAX's ``build_prefill``; no jit: each rank
    calls it eagerly). ``params`` are the rank's slices (``launch.
    sharding.shard_params``), ``tokens [B_rank, seq]`` and the ``extras``
    (``frames``, ``vis_embeds``) its rows of the global ``batch``
    (``sharding.batch_rows``), ``cache`` a cache of ``cache_len`` positions
    from ``sharding.local_cache`` (one is allocated when None). The logits
    ``[B_rank, V or V / M]`` follow ``logits2d``. Decoder-only,
    encoder-decoder and VLM stacks alike, under ``use_mesh`` with the
    rows split over the dp axes where ``batch`` divides them."""
    cache_len = cache_len or seq + cfg.n_vis_tokens

    def fn(params, tokens, extras, cache=None):
        if cache is None:
            cache = shd.local_cache(cfg, batch, cache_len, cache_dtype,
                                    tokens.device, mesh)
        with _mesh_context(mesh, batch, cache_len):
            return prefill(cfg, params, tokens, max_len=cache_len,
                           vis_embeds=extras.get("vis_embeds"),
                           frames=extras.get("frames"),
                           use_kernels=use_kernels, cache=cache)
    return fn


def build_decode(cfg: ModelConfig, mesh, *, batch: int, cache_len: int,
                 use_kernels: bool = True) -> Callable:
    """``fn(params, token [B_rank, 1], cache, pos) -> (logits, cache)`` on
    one rank of ``mesh`` (JAX's ``build_decode``): one token step on
    the rank's cache, updated in place (JAX donates it). On
    QMC streams quantized after the shard every projection runs through
    ``kernels.ops.qmm`` (the decode qmm on the card)."""
    def fn(params, token, cache, pos):
        with _mesh_context(mesh, batch, cache_len):
            return decode_step(cfg, params, token, cache, pos,
                               use_kernels=use_kernels)
    return fn


def logits2d(mesh, batch: int, cfg: ModelConfig) -> Tuple:
    """``[B, V]`` spec of ``build_prefill`` / ``build_decode``'s logits
    (JAX's ``_logits2d``): the batch on the dp axes where it divides, the
    vocab on ``model`` where it divides (an odd vocab, whisper's 51865 or
    internvl's 92553, replicates: every model rank holds the whole
    head)."""
    b_ax, _, v_ax = shd.logits_spec(mesh, batch, cfg)
    return (b_ax, v_ax)


def gather_logits(logits: torch.Tensor, mesh, batch: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """The whole ``[B, V]`` from every rank's block of it under
    ``logits2d``: an all_gather over ``model`` of a vocab slice, then
    over the dp axes of the rank's rows (``pod``-major, as
    ``sharding.batch_rows`` lays them out); kind ``logits`` in
    ``Mesh.by_kind``. For tests and chip_smoke: the steps never need
    it."""
    b_ax, v_ax = logits2d(mesh, batch, cfg)
    if v_ax is not None:
        logits = mesh.all_gather(logits, "model", -1, kind="logits")
    if b_ax is not None:
        for ax in reversed(meshlib.dp_axes(mesh)):
            logits = mesh.all_gather(logits, ax, 0, kind="logits")
    return logits


def _tallies() -> Dict[str, int]:
    """The launch and qmm path counters, flattened."""
    out = {f"launch/{k}": v for k, v in kbuild.launches.items()}
    out.update({f"path/{k}": v for k, v in kops.path_counts.items()})
    return out


def _add_tallies(delta: Dict[str, int], sign: int = 1) -> None:
    for key, n in delta.items():
        kind, name = key.split("/", 1)
        table = kbuild.launches if kind == "launch" else kops.path_counts
        table[name] += sign * n


class _CostTables:
    """The ``obs.costs`` capture tables of one step-set callable: per call
    key, the calls, their synchronous wall seconds and the counted work
    of one call; each recorded call adds to the cumulative ``cost/<name>``
    counter track of the process tracer (rows with no count emit none)."""

    def _init_cost_tables(self, name: str, device: torch.device) -> None:
        self.name = name
        self.device = device
        self.cost_by_key: Dict[str, dict] = {}
        self.calls_by_key: Dict[str, int] = {}
        self.seconds_by_key: Dict[str, float] = {}
        self._cum_flops = self._cum_bytes = 0.0

    def _record(self, key: str, t0: float, excluded_s: float = 0.0) -> None:
        """Close a capture-mode call's timed window (opened at ``t0``):
        wait for the device, then charge the wall since ``t0``, less
        ``excluded_s``, to ``key``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0 - excluded_s
        self.calls_by_key[key] = self.calls_by_key.get(key, 0) + 1
        self.seconds_by_key[key] = self.seconds_by_key.get(key, 0.0) + dt
        cost = self.cost_by_key[key]
        self._cum_flops += cost["flops"]
        self._cum_bytes += cost["bytes"]
        if self._cum_flops or self._cum_bytes:
            obs_trace.get_tracer().counter(
                f"cost/{self.name}", flops=self._cum_flops,
                bytes=self._cum_bytes)


class _Upload:
    """An int32 device buffer filled from the host without blocking it:
    through pinned memory on the card, double-buffered, so a staging
    buffer is rewritten only once the copy that read it has run."""

    def __init__(self, shape, device: torch.device):
        self.dev = torch.zeros(shape, dtype=torch.int32, device=device)
        self.cuda = device.type == "cuda"
        self._stage = [torch.zeros(shape, dtype=torch.int32,
                                   pin_memory=self.cuda)
                       for _ in range(2 if self.cuda else 1)]
        self._done = [None] * len(self._stage)
        self._next = 0

    def host(self) -> torch.Tensor:
        """The staging buffer to fill for the next :meth:`send`."""
        event = self._done[self._next]
        if event is not None and not event.query():
            event.synchronize()
        return self._stage[self._next]

    def send(self) -> torch.Tensor:
        """Copy the filled staging buffer up, on the current stream."""
        i = self._next
        self._next = (i + 1) % len(self._stage)
        self.dev.copy_(self._stage[i], non_blocking=True)
        if self.cuda:
            self._done[i] = torch.cuda.Event()
            self._done[i].record()
        return self.dev


class _Graph:
    """One captured graph of a width: the graph, the launch tallies of its
    capture, and its static outputs."""

    def __init__(self, graph, tally: Dict[str, int], tok: torch.Tensor,
                 logp: torch.Tensor):
        self.graph, self.tally, self.tok, self.logp = graph, tally, tok, logp


class _Width:
    """One token width's static buffers (and, on the card, its graphs,
    keyed by whether the head runs the sampled branch). The inputs are
    views of one packed int32 buffer, so a round's host inputs go up in
    one copy: tokens [B*C] | start [B] | n_new [B] | temp [B] (fp32 bits)
    | top_k [B] | top_p [B] (fp32 bits) | key [B, 2] (uint32 bits) | slot
    [1]."""

    def __init__(self, lanes: int, c: int, device: torch.device):
        self.upload = _Upload((lanes * c + 7 * lanes + 1,), device)
        self.packed = self.upload.dev
        self.tokens = self.packed[:lanes * c].view(lanes, c)
        o = lanes * c
        lane = [self.packed[o + i * lanes:o + (i + 1) * lanes]
                for i in range(5)]
        self.start, self.n_new = lane[0], lane[1]
        self.samp = {"temp": lane[2].view(torch.float32), "top_k": lane[3],
                     "top_p": lane[4].view(torch.float32),
                     "key": self.packed[o + 5 * lanes:o + 7 * lanes].view(
                         lanes, 2)}
        self.slot = self.packed[o + 7 * lanes:]
        self.graphs: Dict[bool, _Graph] = {}
        self.tok: Optional[torch.Tensor] = None
        self.logp: Optional[torch.Tensor] = None


def _host_i32(x) -> torch.Tensor:
    """A host array as int32 bits (float32 and uint32 arrays are
    reinterpreted, not converted)."""
    a = np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float32).view(np.int32)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                            ).reshape(-1)


class GraphedStep(_CostTables):
    """``step`` or ``solo_step`` of a step set: on the card, one CUDA graph
    per declared token width and head (greedy only, or with the sampled
    branch), the same static buffers run eagerly on the CPU or with
    ``cuda_graphs=False`` (see the module docstring).

    ``fn(params, tokens, arena, start, n_new, samp, slot=0)``: host inputs
    are numpy arrays or CPU tensors, ``samp`` a
    ``sampling.lane_inputs`` table of this width's lanes; ``tokens`` may
    also be a tensor on the device (``carry_decode_tokens``). The head
    runs its sampled branch when a live lane (``n_new > 0``) has ``temp >
    0``. A call is :meth:`stage` then :meth:`launch`, which the engine
    calls apart to trace them. Counters: ``calls``, ``creations`` (widths given buffers, at most
    ``len(widths)`` per binding), ``captures`` (at most two heads per
    width), ``compiles`` (captures when graphed, else creations; the
    ``jit/compile`` events) against ``surface`` (two heads per width
    graphed, one buffer set per width eager), ``replays``,
    ``capture_seconds``, ``pool_bytes`` (memory the captures added to the
    shared pool). ``work(params, arena, lanes=, c=)`` counts one call's
    work for ``cost_by_key`` (``obs.costs.step_work``)."""

    def __init__(self, name: str, body: Callable, *, lanes: int,
                 widths: Tuple[int, ...], device: torch.device,
                 cuda_graphs: bool, work: Callable, pool=None,
                 stream: Optional["torch.cuda.Stream"] = None):
        self._init_cost_tables(name, device)
        self.body = body
        self.work = work
        self.lanes = lanes
        self.widths = tuple(widths)
        self.graphed = device.type == "cuda" and cuda_graphs
        self.surface = (2 if self.graphed else 1) * len(self.widths)
        self._pool = pool
        self._stream = stream
        self._widths: Dict[int, _Width] = {}
        self._bound: Optional[tuple] = None
        self.calls = self.creations = self.captures = self.replays = 0
        self.compiles = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0

    def _bind(self, params, arena) -> None:
        """Take (params, arena) as the trees the graphs read; graphs of
        any earlier binding are dropped before anything is captured."""
        if self._bound is not None and self._bound[0] is params \
                and self._bound[1] is arena:
            return
        self._widths.clear()
        self._bound = (params, arena)

    def _width(self, c: int) -> _Width:
        w = self._widths.get(c)
        if w is None:
            if c not in self.widths:
                raise ValueError(f"{self.name}: width {c} is outside the "
                                 f"declared surface {self.widths}")
            t0 = time.perf_counter()
            w = _Width(self.lanes, c, self.device)
            self._widths[c] = w
            self.creations += 1
            if not self.graphed:
                self._grew(c, time.perf_counter() - t0)
        return w

    def _grew(self, c: int, seconds: float) -> None:
        """One compile (see the module docstring): the ``jit/compile``
        instant and counter, and the retrace ones past the surface."""
        self.compiles += 1
        trc = obs_trace.get_tracer()
        trc.instant("jit/compile", fn=self.name, width=c, seconds=seconds)
        reg = obs_metrics.get_registry()
        reg.counter("serve_jit_compiles_total",
                    "step-set graph captures / width creations",
                    labels=("fn",)).inc(fn=self.name)
        if self.compiles > self.surface:
            trc.instant("jit/unexpected_retrace", fn=self.name,
                        compiles=self.compiles, expected=self.surface)
            reg.counter("serve_jit_retraces_unexpected_total",
                        "compiles beyond a step's declared surface",
                        labels=("fn",)).inc(fn=self.name)

    def _stage(self, w: _Width, tokens, start, n_new, samp, slot,
               mark=None) -> None:
        host = w.upload.host()
        lanes, c = w.tokens.shape
        o = lanes * c
        on_device = isinstance(tokens, torch.Tensor) \
            and tokens.device.type != "cpu"
        if not on_device:
            host[:o].copy_(_host_i32(tokens))
        for i, x in enumerate((start, n_new, samp["temp"], samp["top_k"],
                               samp["top_p"])):
            host[o + i * lanes:o + (i + 1) * lanes].copy_(_host_i32(x))
        host[o + 5 * lanes:o + 7 * lanes].copy_(_host_i32(samp["key"]))
        host[o + 7 * lanes] = int(slot)
        if mark is not None:
            mark()
        w.upload.send()
        if on_device:
            w.tokens.copy_(tokens)

    def _run(self, params, arena, w: _Width, sampled: bool, **inputs):
        with torch.no_grad():
            return self.body(params, inputs.get("tokens", w.tokens), arena,
                             inputs.get("start", w.start),
                             inputs.get("n_new", w.n_new),
                             inputs.get("samp", w.samp),
                             inputs.get("slot", w.slot), sampled)

    def _capture(self, params, arena, w: _Width, sampled: bool) -> _Graph:
        """Warm the width's head up on the capture stream with every lane
        idle (its only writes land on the null page: the kernel library
        loads, the decode qmm's tickets and each kernel's shared-memory
        opt-in happen outside the capture), then capture it."""
        dev = self.device
        lanes, c = w.tokens.shape
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            zeros = torch.zeros(lanes, dtype=torch.int32, device=dev)
            self._run(params, arena, w, sampled,
                      tokens=torch.zeros((lanes, c), dtype=torch.int32,
                                         device=dev),
                      start=zeros, n_new=zeros,
                      samp={k: torch.zeros_like(v)
                            for k, v in w.samp.items()},
                      slot=torch.zeros(1, dtype=torch.int32, device=dev))
        torch.cuda.current_stream(dev).wait_stream(self._stream)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = _tallies()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            tok, logp = self._run(params, arena, w, sampled)
        self.capture_seconds += time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        after = _tallies()
        tally = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        _add_tallies(tally, -1)           # the capture launched nothing
        self.captures += 1
        return _Graph(graph, tally, tok, logp)

    def __call__(self, params, tokens, arena, start, n_new, samp, slot=0):
        return self.launch(self.stage(params, tokens, arena, start, n_new,
                                      samp, slot))

    def stage(self, params, tokens, arena, start, n_new, samp, slot=0,
              mark=None) -> tuple:
        """A call's first half: binds the trees, picks the width and head,
        packs the inputs and enqueues their upload; ``mark()``, where
        given, runs just before the upload's enqueue (the engine's device
        span starts there). Returns what :meth:`launch` takes."""
        capture = obs_costs.capture_enabled()
        t0 = time.perf_counter()
        self.calls += 1
        self._bind(params, arena)
        c = int(tokens.shape[1])
        w = self._width(c)
        key = f"C{c}"
        if capture and key not in self.cost_by_key:
            self.cost_by_key[key] = self.work(params, arena,
                                              lanes=self.lanes, c=c)
        sampled = bool(np.any((np.asarray(samp["temp"]) > 0)
                              & (np.asarray(n_new) > 0)))
        self._stage(w, tokens, start, n_new, samp, slot, mark)
        return params, arena, w, c, sampled, capture, t0

    def launch(self, staged: tuple):
        """A call's second half: the replay (capturing the width's graph
        first if it has none), or the eager run; returns the static
        outputs."""
        params, arena, w, c, sampled, capture, t0 = staged
        captured_s = 0.0
        if not self.graphed:
            tok, logp = self._run(params, arena, w, sampled)
            if w.tok is None:
                w.tok, w.logp = torch.empty_like(tok), torch.empty_like(logp)
            w.tok.copy_(tok)
            w.logp.copy_(logp)
            out = w.tok, w.logp
        else:
            g = w.graphs.get(sampled)
            if g is None:
                tc = time.perf_counter()
                g = w.graphs[sampled] = self._capture(params, arena, w,
                                                      sampled)
                captured_s = time.perf_counter() - tc
                self._grew(c, captured_s)
            g.graph.replay()
            _add_tallies(g.tally)
            self.replays += 1
            out = g.tok, g.logp
        if capture:
            self._record(f"C{c}", t0, captured_s)
        return out


class PageOps(_CostTables):
    """``apply_page_ops`` of a step set: the host block tables, the
    round's page copies and its state-reset slots go up in one copy
    without blocking the host (through the double-buffered staging of
    :class:`_Upload`, so a staging buffer is rewritten only after the
    copy that read it has run), then the copies run, the tables are
    written into every group's ``block_tbl`` and the reset slots' SSM and
    conv rows are zeroed. At most ``max_slots`` copies a call (the JAX
    engine's batch; the engine drains more in extra calls); a call with
    none runs no copy, one with no reset zeroes nothing. Under
    ``obs.costs`` capture its calls land in the ``call`` row, with no
    count."""

    def __init__(self, max_slots: int, max_pages_per_seq: int,
                 device: torch.device, mesh=None,
                 page_slice: Optional[Tuple[int, int]] = None,
                 rows: Optional[slice] = None):
        self._init_cost_tables("apply_page_ops", device)
        self.mesh, self.page_slice, self.rows = mesh, page_slice, rows
        self.slots = max_slots
        self.n_tbl = max_slots * max_pages_per_seq
        self.shape = (max_slots, max_pages_per_seq)
        self.upload = _Upload((self.n_tbl + 3 * max_slots,), device)

    def __call__(self, arena: dict, tables, copies=(), resets=(),
                 mark=None) -> dict:
        """``mark()``, where given, runs just before the upload's enqueue
        (the engine's device span starts there)."""
        capture = obs_costs.capture_enabled()
        t0 = time.perf_counter()
        copies = list(copies)
        if len(copies) > self.slots:
            raise ValueError(f"{len(copies)} page copies in one call; at "
                             f"most {self.slots}")
        host = self.upload.host()
        host[:self.n_tbl].copy_(_host_i32(tables))
        lanes = np.zeros((3, self.slots), np.int32)   # src | dst | reset
        for i, (src, dst) in enumerate(copies):
            lanes[:2, i] = src, dst
        for slot in resets:
            lanes[2, slot] = 1
        host[self.n_tbl:].copy_(torch.from_numpy(lanes.reshape(-1)))
        if mark is not None:
            mark()
        dev = self.upload.send()
        o, n = self.n_tbl, self.slots
        apply_page_ops(arena, dev[:o].view(self.shape),
                       dev[o:o + n] if copies else None,
                       dev[o + n:o + 2 * n] if copies else None,
                       dev[o + 2 * n:] if len(resets) else None,
                       self.mesh, self.page_slice, self.rows)
        if capture:
            self.cost_by_key.setdefault("call", {"flops": 0.0, "bytes": 0.0})
            self._record("call", t0)
        return arena


@dataclasses.dataclass(frozen=True)
class PagedServeSteps:
    """The step callables one paged engine runs, and the geometry they
    were built for (the engine checks it with :meth:`compatible_with`).

      step(params, tokens [B, C], arena, start [B], n_new [B], samp)
          -> (tok [B, C], logp [B, C])   graphs per C on the card
      solo_step(params, tokens [1, C], arena, start [1], n_new [1],
                samp (one lane), slot) -> (tok [1, C], logp [1, C])
                (None on a mesh)
      apply_page_ops(arena, tables [B, P], copies=[(src, dst), ...],
                     resets=[slot, ...]) -> arena
      reset_state(arena, slot) -> arena   (None without SSM state)

    The arena is updated in place; outputs are the width's static
    buffers, valid until the next call at that width."""
    cfg: ModelConfig
    page: int
    n_pages: int                     # usable pages (arena holds +1 null)
    max_slots: int
    max_pages_per_seq: int
    cache_dtype: object
    chunk: int                       # prefill chunk width (top rung)
    paged_attention: bool
    device: torch.device
    cuda_graphs: bool
    step: GraphedStep
    solo_step: Optional[GraphedStep]
    apply_page_ops: PageOps
    reset_state: Optional[Callable] = None
    mesh: Optional[object] = None
    page_slice: Optional[Tuple[int, int]] = None
    rows: Optional[slice] = None     # a rank's lanes (launch.sharding.
                                     # serve_rows); None: every lane

    @property
    def rows_per_rank(self) -> int:
        """Lanes this rank runs through the layers outside attention."""
        if self.rows is None:
            return self.max_slots
        return self.rows.stop - self.rows.start

    def compatible_with(self, *, page, n_pages, max_slots,
                        max_pages_per_seq, cache_dtype, chunk,
                        paged_attention) -> bool:
        return (self.page == page and self.n_pages == n_pages
                and self.max_slots == max_slots
                and self.max_pages_per_seq == max_pages_per_seq
                and self.cache_dtype == cache_dtype
                and self.chunk == chunk
                and self.paged_attention == paged_attention)

    def capture_counters(self) -> Tuple[int, int, float]:
        """(calls, captures, capture seconds) over ``step`` and
        ``solo_step``: the counterpart of the JAX set's ``jit_counters``
        (the engine takes their differences around a run)."""
        fns = self.callables
        return (sum(f.calls for f in fns), sum(f.captures for f in fns),
                sum(f.capture_seconds for f in fns))

    @property
    def callables(self) -> Tuple[GraphedStep, ...]:
        """``step`` and, off a mesh, ``solo_step``."""
        return tuple(f for f in (self.step, self.solo_step)
                     if f is not None)

    @property
    def replays(self) -> int:
        return sum(f.replays for f in self.callables)

    @property
    def pool_bytes(self) -> int:
        """Device memory the captures added to the shared graph pool."""
        return sum(f.pool_bytes for f in self.callables)


def build_paged_steps(cfg: ModelConfig, *, page: int, n_pages: int,
                      max_slots: int, max_pages_per_seq: int,
                      cache_dtype, chunk: Optional[int] = None,
                      paged_attention: bool = True, device="cuda",
                      cuda_graphs: bool = True, mesh=None,
                      page_slice: Optional[Tuple[int, int]] = None
                      ) -> PagedServeSteps:
    """The step set of one engine geometry. ``step`` and ``solo_step``
    each declare ``len(width_ladder(chunk)) + 1`` widths, the compile
    surface the JAX ``build_paged_steps`` declares per callable (with
    two heads per width on the card); their graphs share one memory pool
    and one capture stream. With a ``mesh`` it is the mesh step set (see
    the module docstring): ``page_slice`` is the rank's ``(first, pages)``
    of the arena when the data axis is over 1, and ``cuda_graphs`` must
    be False."""
    dev = resolve_device(device)
    rows = None
    if mesh is not None:
        check_mesh_cfg(cfg)
        if meshlib.axis_size(mesh, "pod") > 1:
            raise NotImplementedError(
                "the mesh step set serves on a (data, model) mesh: its "
                "pages and lanes split over 'data'")
        rows = shd.serve_rows(mesh, max_slots)
        if cuda_graphs:
            raise ValueError(
                "the mesh step set runs eagerly: pass cuda_graphs=False "
                "(gloo collectives cannot be captured in a CUDA graph, and "
                "NCCL inside one waits for a host with a card per rank)")
        if not paged_attention:
            raise NotImplementedError(
                "the mesh step set attends through the ragged kernel over "
                "each rank's page slice (paged_attention=True)")
    if chunk is None:
        chunk = default_chunk(max_pages_per_seq, page)
    widths = (1,) + width_ladder(chunk)
    pool = stream = None
    if dev.type == "cuda" and cuda_graphs:
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(dev)
    kw = dict(paged_attention=paged_attention)
    dp = meshlib.dp_axes(mesh) if mesh is not None else ()

    def step_body(params, tokens, arena, start, n_new, samp, slot, sampled):
        if mesh is None:
            return step(cfg, params, tokens, arena, start, n_new, samp,
                        sampled=sampled, **kw)
        with ctx.use_mesh(mesh, dp, page_slice):
            return step(cfg, params, tokens, arena, start, n_new, samp,
                        sampled=sampled, rows=rows, **kw)

    def solo_body(params, tokens, arena, start, n_new, samp, slot, sampled):
        return solo_step(cfg, params, tokens, arena, slot, start, n_new,
                         samp, sampled=sampled, **kw)

    common = dict(widths=widths, device=dev, cuda_graphs=cuda_graphs,
                  work=functools.partial(
                      obs_costs.step_work, cfg,
                      rows=None if rows is None else rows.stop - rows.start),
                  pool=pool, stream=stream)
    return PagedServeSteps(
        cfg=cfg, page=page, n_pages=n_pages, max_slots=max_slots,
        max_pages_per_seq=max_pages_per_seq, cache_dtype=cache_dtype,
        chunk=chunk, paged_attention=paged_attention, device=dev,
        cuda_graphs=cuda_graphs,
        step=GraphedStep("step", step_body, lanes=max_slots, **common),
        solo_step=(GraphedStep("solo_step", solo_body, lanes=1, **common)
                   if mesh is None else None),
        apply_page_ops=PageOps(max_slots, max_pages_per_seq, dev, mesh,
                               page_slice, rows),
        reset_state=(functools.partial(reset_state, rows=rows) if any(
            k == "mamba" or k.startswith("hybrid") for k in cfg.pattern)
            else None),
        mesh=mesh, page_slice=page_slice, rows=rows)


def check_mesh_cfg(cfg: ModelConfig) -> None:
    """The mesh step set serves every stack the paged engine serves:
    dense, local/global, MoE (experts over ``model``), SSM and hybrid
    (the Mamba2 mixer replicated on every model rank; ``launch.
    sharding``), with heads or a vocab that do not divide ``model``
    replicated. Encoder-decoder and VLM stacks, which the paged engine
    serves neither alone nor on a mesh, run on a mesh through the
    contiguous ``build_prefill`` / ``build_decode``, as in JAX."""
    if cfg.is_encdec or cfg.n_vis_tokens:
        raise NotImplementedError(
            f"the paged step set serves decoder-only stacks (dense, "
            f"local/global, MoE, SSM, hybrid); {cfg.name} (family "
            f"{cfg.family}) runs on a mesh through the contiguous "
            f"serve.steps.build_prefill / build_decode")
