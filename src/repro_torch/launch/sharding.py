"""Sharding rules of the mesh (counterpart of ``repro.launch.sharding``),
written as the local slice each rank holds.

``param_spec``, ``_qtensor_field_spec`` and ``paged_cache_spec`` are the
JAX rules, one entry per dim (an axis name or None, a PartitionSpec as a
tuple): name-based over the flattened parameter path, stacked leaves
(``blocks/``, ``encoder/blocks/``, ``xattn/``) with a leading None, and a
dim that does not divide its axis replicated, as ``_finalize`` does.

Given the model's config (``cfg``), an attention block whose heads or KV
heads do not divide ``model`` replicates over it whole: ``attn/w[qkvo]``
and ``attn/b[qkvo]``, under ``xattn/`` and ``encoder/blocks/`` too, keep
their ``data`` (FSDP) cut and lose their ``model`` one, and every model
rank runs every head of the block (``layers.attn_replicated``). The dim
rule alone cannot decide this: hymba-1.5b's ``wq`` has 1600 columns and
its ``wk`` / ``wv`` 320, which divide 2 but would give a rank 12.5 and
2.5 heads. JAX cuts the columns and lets GSPMD reshard; the port runs
the block whole, with the same result. A vocab that does not divide
``model`` needs no rule of its own: ``_finalize`` replicates the
embedding's and the head's vocab dim, and the model code reads the
table's width.

Serving departs from them in three ways, each with the same result:

  * the ``data`` entries of ``_RULES`` are FSDP, a training layout, so
    ``serving_spec`` drops them and every serving weight is replicated
    over ``data``;
  * ``mamba/conv_w`` stays whole (JAX cuts its channels over ``model``):
    the Mamba2 mixer runs replicated on every model rank, so it needs the
    whole conv;
  * a QTensor expert list is cut by experts (EP) or each expert by its
    subtile grid, where JAX replicates a ``[G, E]`` QTensor stack whose
    E does not divide ``model`` (``_qtensor_field_spec``).

What remains is TP and EP on ``model``:

  * column-parallel: ``wq``/``wk``/``wv``, ``w_gate``/``w_up``,
    ``in_proj`` (the Mamba2 mixer makes its outputs whole right after the
    product: ``layers.gathered_linear``) and ``lm_head`` over the vocab;
    the embedding table over the vocab too (a vocab-parallel lookup, one
    reduce);
  * row-parallel: ``wo``, ``w_down`` and ``out_proj`` (one all_reduce over
    the model group after each, in ``models``);
  * MoE experts: when ``E % M == 0`` rank ``m`` keeps experts ``[m E/M,
    (m + 1) E/M)`` of every group whole (``_MOE_EXPERT_RULES`` with its
    ``data`` entries dropped; ``expert_range``): a dense ``[G, E, d,
    ff]`` stack is sliced to ``[G, E/M, d, ff]``, a ``[G][E]`` QTensor
    list keeps its length with ``None`` where another rank holds the
    expert. Otherwise every expert is cut Megatron-style, as JAX's
    fallback: ``w_gate``/``w_up`` by columns and ``w_down`` by rows (a
    QTensor through ``shard_qtensor``, into a plain QTensor of the rank's
    slice, where the cut falls on subtile boundaries, replicated where it
    does not). ``models.moe`` sums a layer's experts once over ``model``.

A ShardedQTensor of ``M`` shards gives rank ``m`` shard ``m``
(``_qtensor_field_spec``: the shard dim on ``model``); a QTensor at a TP
site is cut along its subtile grid into the rank's slice
(``shard_qtensor``) where the cut falls on subtile boundaries, and
replicated where it does not (a dim that does not divide).

The paged arena: pages over ``data`` (rank ``d`` holds global pages
``[d * n_local, (d + 1) * n_local)``, so the null page 0 lives on data
rank 0) and the fused KV dim over ``model`` where the KV heads divide it
(whole heads a rank), every KV head on every model rank where they do
not (the block replicates); block tables replicate. On a mesh with ``D >
1`` each rank's slice carries one more page past its ``n_local``, the
sink: the K/V rows of pages other ranks hold are written there, and no
block table ever maps it. The serving step's batch follows JAX's
``batch_spec`` over ``max_slots`` (``serve_rows``): where the slots
divide the dp axes, data rank ``k`` runs lanes ``[k B / D, (k + 1) B /
D)`` through every layer outside attention and holds only those lanes'
SSM and conv rows (``paged_cache_spec``: the slot dim on ``data``);
where they do not, every rank runs every lane and holds every row. Every
model rank runs the whole mixer over its rows.

The contiguous cache (``cache_spec``, ``local_cache``, ``shard_cache``;
``serve.steps.build_prefill`` / ``build_decode``): the batch rows over
the dp axes where the global batch divides them; where it does not, the
K/V sequence over ``data`` (JAX's sequence-parallel cache: data rank
``d`` holds positions ``[d T / D, (d + 1) T / D)`` of every row,
``seq_slice``) where ``T`` divides it, else every position on every
rank; the KV columns as the arena's, the cross-attention's K/V by the
rank's KV heads, the SSM and conv state whole over ``model`` (and over
``data`` where the batch does not divide).

Training (every stack: dense, local/global attention, MoE, Mamba2,
hybrid, encoder-decoder and VLM; ``check_train_mesh`` refuses only a
``d_ff`` that does not divide ``model``) keeps the JAX rules whole (FSDP
on ``data``, TP on ``model``; ``train_specs``, ``train_slices``): every
large parameter is cut along both, and a dim that does not divide its
axis replicates, as ``_finalize`` does (an attention block whose heads do
not divide ``model`` whole, given ``cfg``). Each rank holds its slice of
the parameters, of the gradients and of both AdamW moments. The leaves that end up replicated
over ``data`` are the norms (``norm1``, ``norm2``, ``final_norm``), the
attention biases (``bq``/``bk``/``bv``) and any leaf whose FSDP dim does
not divide the data axis; their gradients need a SUM over ``data`` in
place of the reduce-scatter (``grad_axes``), and the global norm counts
them once (``owns``). The attention biases are also replicated over
``model`` while each rank adds only its heads' slice of them, so their
gradients are partial there and take a SUM over ``model`` (not in a
replicated attention block, whose every leaf, like a replicated
embedding and head, gets its whole gradient on every model rank); so is
the MoE router, replicated over ``model`` while each rank's gates combine
only its experts (``models.moe``). The MoE expert stacks follow the
expert rules (EP on ``model`` when it divides ``E``, else the Megatron
cut of each expert's hidden units), FSDP on their ``d`` dim. The Mamba2
mixer's replicated leaves get whole gradients on every model rank
(``models.ssm``), so they take no SUM over ``model``; ``conv_w`` keeps
JAX's cut of its channels over ``model`` and is gathered before use.
The ``pod`` axis is pure data parallelism: every leaf replicates over it
and every gradient takes a SUM over it. ``fsdp_gather`` makes a group's leaves
whole along their ``data`` dim just before use; ``unshard`` makes a
whole tree (a checkpoint, the tests); ``batch_spec`` / ``batch_rows``
put the global batch over ``(pod, data)`` when it divides, and with
microbatches give each dp rank its share of each global microbatch (the
reference splits the global batch into consecutive chunks, and an MoE
block's capacity and aux depend on which rows share one).
"""
from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core.qtensor import QTensor
from repro_torch.core.qtensor_sharded import ShardedQTensor, shard_qtensor
from repro_torch.core.serving_quant import ROW_SHARDED
from repro_torch.launch import collectives as C
from repro_torch.launch import mesh as meshlib
from repro_torch.models import kvcache as KV
from repro_torch.models.layers import attn_replicated, rank_config

_STACKED_PREFIXES = ("blocks/", "encoder/blocks/", "xattn/")
# the leaves of an attention block: self-attention, the encoder's and the
# decoder's cross-attention (``xattn/xattn/``)
_ATTN_LEAF = r"attn/(w[qkvo]|b[qkvo])$"

# (regex on path, spec for the trailing (non-stacked) dims)
_RULES = [
    (r"embed/tok$",            ("model", "data")),
    (r"lm_head$",              ("data", "model")),
    (r"pos_emb$",              (None, None)),
    # attention
    (r"attn/w[qkv]$",          ("data", "model")),
    (r"attn/wo$",              ("model", "data")),
    (r"attn/b[qkvo]$",         (None,)),
    # dense FFN
    (r"ffn/w_(gate|up)$",      ("data", "model")),
    (r"ffn/w_down$",           ("model", "data")),
    # MoE FFN (leaf ndim 3 without stacking: [E, d, ff])
    (r"ffn/router$",           ("data", None)),
    # mamba
    (r"mamba/in_proj$",        ("data", "model")),
    (r"mamba/out_proj$",       ("model", "data")),
    (r"mamba/conv_w$",         ("model", None)),
    (r"mamba/(a_log|dt_bias|d_skip)$", (None,)),
    (r"mamba/norm_scale$",     (None,)),
    (r"norm",                  (None,)),
]
_MOE_EXPERT_RULES = {
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}


def _strip_axes(spec: Tuple, mesh) -> Tuple:
    """Drop axes the mesh does not have."""
    names = mesh.axis_names
    return tuple((a if (a in names) else None) for a in spec)


def _finalize(spec, stacked, ndim, shape, mesh) -> Tuple:
    spec = tuple(spec)
    if stacked:
        spec = (None,) + spec
    spec = spec + (None,) * (ndim - len(spec))
    spec = _strip_axes(spec, mesh)
    # a sharding that does not divide its dim replicates it
    return tuple(ax if ax is None or dim % meshlib.axis_size(mesh, ax) == 0
                 else None for dim, ax in zip(shape, spec))


def replicated_attn_leaf(path: str, cfg, mesh) -> bool:
    """Whether ``path`` is a leaf of an attention block (``attn/``,
    ``xattn/``, ``encoder/blocks/attn/``) that replicates over ``model``
    because ``cfg``'s heads or KV heads do not divide it
    (``layers.attn_replicated``)."""
    return (cfg is not None and re.search(_ATTN_LEAF, path) is not None
            and attn_replicated(cfg, meshlib.axis_size(mesh, "model")))


def param_spec(path: str, leaf, mesh, cfg=None) -> Tuple:
    """The JAX PartitionSpec of one parameter leaf, as a tuple; with
    ``cfg``, an attention block whose heads do not divide ``model``
    replicates over it whole (its ``data`` cut kept)."""
    spec = _dim_spec(path, leaf, mesh)
    if replicated_attn_leaf(path, cfg, mesh):
        spec = tuple(None if ax == "model" else ax for ax in spec)
    return spec


def _dim_spec(path: str, leaf, mesh) -> Tuple:
    """``param_spec`` by the leaf's name and dims alone."""
    stacked = any(path.startswith(p) or ("/" + p) in path
                  for p in _STACKED_PREFIXES)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    base_ndim = ndim - (1 if stacked else 0)
    m = re.search(r"ffn/(w_gate|w_up|w_down)$", path)
    if m is not None and base_ndim == 3:      # MoE experts [.., E, d, ff]
        e = shape[1] if stacked else shape[0]
        if e % meshlib.axis_size(mesh, "model") == 0:
            spec = _MOE_EXPERT_RULES[m.group(1)]
        else:
            spec = {"w_gate": (None, "data", "model"),
                    "w_up": (None, "data", "model"),
                    "w_down": (None, "model", "data")}[m.group(1)]
        return _finalize(spec, stacked, ndim, shape, mesh)
    for pat, spec in _RULES:
        if re.search(pat, path):
            if len(spec) != base_ndim:
                spec = tuple(spec[:base_ndim]) + (None,) * max(
                    0, base_ndim - len(spec))
            return _finalize(spec, stacked, ndim, shape, mesh)
    return _finalize((None,) * base_ndim, stacked, ndim, shape, mesh)


def serving_spec(path: str, leaf, mesh, cfg=None) -> Tuple:
    """``param_spec`` with its FSDP ``data`` entries dropped: serving
    weights are replicated over ``data``. ``mamba/conv_w`` stays whole:
    the mixer runs replicated on every model rank."""
    if path.endswith("mamba/conv_w"):
        return (None,) * len(leaf.shape)
    return tuple(None if ax == "data" else ax
                 for ax in param_spec(path, leaf, mesh, cfg))


def expert_range(n_experts: int, mesh) -> Tuple[int, int]:
    """``[first, stop)`` of the experts this rank holds whole: its
    ``E / M`` of them when the model axis divides ``E`` (expert
    parallelism), else all of them (each cut Megatron-style, or whole off
    a mesh)."""
    tp_n = meshlib.axis_size(mesh, "model") if mesh is not None else 1
    if tp_n == 1 or n_experts % tp_n:
        return 0, n_experts
    n = n_experts // tp_n
    m = mesh.index("model")
    return m * n, (m + 1) * n


_QT_BASE = {"in_codes": 3, "out_codes": 3, "stream_pos": 2, "is_out": 2,
            "scale_in": 2, "scale_out": 2}


def _qtensor_field_spec(path: str, leaf, mesh) -> Tuple:
    """A QTensor stream field: the innermost lead dim (TP shard or
    expert) on ``model`` when it divides, everything else replicated."""
    field = path.split("/")[-1]
    lead = len(leaf.shape) - _QT_BASE[field]
    if lead <= 0:
        return ()
    tp_n = meshlib.axis_size(mesh, "model")
    ax = "model" if ("model" in mesh.axis_names
                     and leaf.shape[lead - 1] % tp_n == 0) else None
    spec = [None] * len(leaf.shape)
    spec[lead - 1] = ax
    return tuple(spec)


def paged_cache_spec(path: str, leaf, mesh, cfg=None) -> Tuple:
    """Paged arena leaves (stacked ``[G, ...]``): ``*_pages`` pages on
    ``data`` and the last dim on ``model`` where each divides (with
    ``cfg``, only where the KV heads divide it too: whole heads a rank);
    block tables replicated; dense mamba state batch on dp."""
    tp_n = meshlib.axis_size(mesh, "model")
    if cfg is not None and attn_replicated(cfg, tp_n):
        tp_n = 1
    data_n = meshlib.axis_size(mesh, "data")
    shape = tuple(leaf.shape)

    def div(dim, ax, n):
        return ax if (n > 1 and dim % n == 0) else None

    if path.endswith("_pages"):
        g, n_pages, page, last = shape
        return (None, div(n_pages, "data", data_n), None,
                div(last, "model", tp_n))
    if path.endswith("block_tbl"):
        return ()
    if path.endswith("/ssm") or path.endswith("/conv"):
        dp = meshlib.dp_axes(mesh)
        spec = [None] * len(shape)
        if len(dp) == 1:
            spec[1] = div(shape[1], dp[0], meshlib.dp_size(mesh))
        return tuple(spec)
    return ()


def local_slices(spec: Tuple, shape: Tuple[int, ...], mesh) -> Tuple:
    """The index of this rank's block of a ``shape`` leaf under
    ``spec``."""
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        n = meshlib.axis_size(mesh, ax)
        if n == 1:
            out.append(slice(None))
            continue
        k = mesh.index(ax)
        out.append(slice(k * dim // n, (k + 1) * dim // n))
    return tuple(out)


# ---------------------------------------------------------------------------
# a rank's parameters and arena
# ---------------------------------------------------------------------------
# the projections TP cuts (column-parallel, then row-parallel)
_TP_SITES = ("wq", "wk", "wv", "w_gate", "w_up", "in_proj",
             "lm_head") + ROW_SHARDED


def _shard_experts(name: str, row: list, mesh) -> list:
    """One group's ``[E]`` expert list on this rank: under expert
    parallelism its experts whole and ``None`` elsewhere; otherwise each
    expert cut at subtile boundaries into the plain QTensor of its slice
    (columns for ``w_gate``/``w_up``, rows for ``w_down``; whole where
    the cut would split a subtile). ``models.moe`` sums the layer once."""
    tp_n = meshlib.axis_size(mesh, "model")
    if tp_n == 1:
        return row
    lo, hi = expert_range(len(row), mesh)
    if hi - lo < len(row):
        return [q if lo <= i < hi else None for i, q in enumerate(row)]
    m = mesh.index("model")
    axis = 0 if name in ROW_SHARDED else 1
    out = []
    for q in row:
        cut = shard_qtensor(q, tp_n, axis, only=m)
        out.append(q if cut is None else cut.local(m))
    return out


def _shard_stream(path: str, leaf, mesh, cfg=None):
    tp_n = meshlib.axis_size(mesh, "model")
    m = mesh.index("model")
    name = path.split("/")[-1]
    if isinstance(leaf, list):
        if leaf and isinstance(leaf[0], list):   # [G][E] experts
            return [_shard_experts(name, row, mesh) for row in leaf]
        return [_shard_stream(path, q, mesh, cfg) for q in leaf]
    if replicated_attn_leaf(path, cfg, mesh):
        # every model rank runs the whole block through one qmm
        if isinstance(leaf, ShardedQTensor) and leaf.n_shards > 1:
            raise ValueError(
                f"{path}: {cfg.name}'s attention replicates over "
                f"{tp_n} model ranks and runs whole streams; this one "
                f"is quantized in {leaf.n_shards} shards (quantize it "
                f"with tp_shards=1)")
        return leaf
    if isinstance(leaf, ShardedQTensor):
        if leaf.n_shards == tp_n and tp_n > 1:
            return leaf if list(leaf.held) == [m] else leaf.select(m)
        return leaf
    if isinstance(leaf, QTensor) and tp_n > 1 and name in _TP_SITES:
        axis = 0 if name in ROW_SHARDED else 1
        return shard_qtensor(leaf, tp_n, axis, only=m) or leaf
    return leaf


def shard_params(params, mesh, cfg=None):
    """This rank's parameters: dense leaves sliced by ``serving_spec``,
    ShardedQTensors of ``M`` shards reduced to the rank's shard (one that
    holds the rank's shard alone passes through), QTensors at TP sites cut
    into the rank's slice, ``[G][E]`` expert lists by ``_shard_experts``
    (a list that holds the rank's experts alone passes through). With
    ``cfg``, an attention block whose heads do not divide ``model`` stays
    whole, streams and all."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            idx = local_slices(serving_spec(path, tree, mesh, cfg),
                               tree.shape, mesh)
            if all(s == slice(None) for s in idx):
                return tree
            return tree[idx].contiguous()
        return _shard_stream(path, tree, mesh, cfg)
    return walk(params, "")


def page_slice(n_pages_total: int, mesh) -> Tuple[int, int]:
    """``(first page, pages)`` of this rank's slice of an arena of
    ``n_pages_total`` pages (the null page included)."""
    d = meshlib.axis_size(mesh, "data")
    if n_pages_total % d:
        raise ValueError(f"{n_pages_total} arena pages do not divide the "
                         f"data axis ({d}); size the pool with "
                         f"serve.steps.default_n_pages(..., mesh)")
    n = n_pages_total // d
    return mesh.index("data") * n, n


def serve_rows(mesh, max_slots: int) -> Optional[slice]:
    """The lanes this rank runs through every layer outside attention
    (JAX's ``batch_spec`` over ``max_slots``): lanes ``[k B / D, (k + 1) B
    / D)`` of dp rank ``k`` where ``max_slots`` divides the dp size ``D >
    1``; None where every rank runs every lane (``D = 1``, or slots that
    do not divide ``D``, where ``batch_spec`` replicates)."""
    if meshlib.dp_size(mesh) == 1 or not batch_spec(mesh, max_slots):
        return None
    return batch_rows(mesh, max_slots)


def _state_rows(path: str, leaf, mesh):
    """The index of this rank's block of an arena's SSM or conv leaf
    (``paged_cache_spec``: its slots on ``data`` where they divide it)."""
    return local_slices(paged_cache_spec(path, leaf, mesh), leaf.shape,
                        mesh)


def local_arena(cfg, n_pages_total: int, page: int, max_slots: int,
                max_pages_per_seq: int, dtype, device, mesh) -> dict:
    """This rank's zeroed arena: its slice of ``n_pages_total`` pages (the
    sink page after them when ``D > 1``), of the KV heads (all of them
    where they do not divide ``model``) and of the slots' SSM and conv
    rows (``serve_rows``); block tables whole."""
    _, n = page_slice(n_pages_total, mesh)
    sink = meshlib.axis_size(mesh, "data") > 1
    lcfg = rank_config(cfg, meshlib.axis_size(mesh, "model"))
    arena = KV.paged_init_cache(lcfg, n + int(sink), page, max_slots,
                                max_pages_per_seq, dtype, device)
    for key, grp in arena.items():
        if "mamba" in grp:
            grp["mamba"] = {
                name: leaf[_state_rows(f"/{key}/mamba/{name}", leaf,
                                       mesh)].contiguous()
                for name, leaf in grp["mamba"].items()}
    return arena


def shard_arena(arena: dict, mesh, cfg=None) -> dict:
    """This rank's slice of a whole arena (JAX layout, every page of
    every KV head; ``paged_cache_spec``, with ``cfg`` every KV head where
    they do not divide ``model``), with the sink page (zeros) when ``D >
    1`` and the rank's SSM and conv rows; block tables are copied
    whole."""
    sink = meshlib.axis_size(mesh, "data") > 1

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if path.endswith(("/ssm", "/conv")):
            return tree[_state_rows(path, tree, mesh)].clone()
        if not path.endswith("_pages"):
            return tree.clone()
        spec = paged_cache_spec(path, tree, mesh, cfg)
        first, n = page_slice(tree.shape[1], mesh)
        idx = list(local_slices(spec, tree.shape, mesh))
        idx[1] = slice(first, first + n)
        t = tree[tuple(idx)]
        if sink:
            t = torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
        return t.contiguous()
    return walk(arena, "")


# ---------------------------------------------------------------------------
# the contiguous cache (``prefill`` / ``decode_step`` on a mesh)
# ---------------------------------------------------------------------------
def cache_spec(path: str, leaf, mesh, global_batch: int, cfg=None
               ) -> Tuple:
    """A contiguous cache leaf's spec (stacked ``[G, ...]``; JAX's
    ``cache_spec``): the batch dim on the dp axes where the global batch
    divides them, else the K/V sequence on ``data`` where it divides
    ``data`` (the sequence-parallel cache). K/V ``[G, B, T, KV * hd]``
    and their int8 scales ``[G, B, T, KV]`` keep the fused (or head) dim
    on ``model`` where it divides and, with ``cfg``, only where the KV
    heads divide ``model`` (all of them on every model rank where they do
    not: the replicated block).

    Two departures from JAX, each with the same results:
      * the cross-attention's ``xk`` / ``xv`` ``[L, B, T, KV, hd]`` hold
        the rank's KV heads under TP (JAX keeps them whole): the rank
        computes only its heads' cross K/V;
      * the SSM and conv state is whole over ``model`` (JAX cuts its
        heads and channels): the Mamba2 mixer runs whole on every model
        rank, as in the paged arena (``paged_cache_spec``)."""
    tp_n = meshlib.axis_size(mesh, "model")
    if cfg is not None and attn_replicated(cfg, tp_n):
        tp_n = 1
    b_ax = (_dp_entry(mesh) if batch_spec(mesh, global_batch) else None)

    def heads(dim):
        return "model" if tp_n > 1 and dim % tp_n == 0 else None

    shape = tuple(leaf.shape)
    if path.endswith(("/k", "/v", "k_scale", "v_scale")):
        seq = None
        if b_ax is None and shape[2] % meshlib.axis_size(mesh, "data") == 0:
            seq = "data"
        return (None, b_ax, seq, heads(shape[3]))
    if path.endswith(("xk", "xv")):
        return (None, b_ax, None, heads(shape[3]), None)
    if path.endswith(("/ssm", "/conv")):
        return (None, b_ax) + (None,) * (len(shape) - 2)
    return ()


def seq_slice(mesh, global_batch: int, cache_len: int
              ) -> Optional[Tuple[int, int, int]]:
    """``(first, n, total)``: the positions ``[first, first + n)`` of a
    ``cache_len`` contiguous cache this rank holds under ``cache_spec``'s
    sequence cut (data rank ``d``: ``n = T / D``, ``first = d n``); None
    where it holds every position (the batch divides the dp axes, ``T``
    does not divide ``data``, or ``data`` is 1)."""
    d = meshlib.axis_size(mesh, "data")
    if d == 1 or batch_spec(mesh, global_batch) or cache_len % d:
        return None
    n = cache_len // d
    return mesh.index("data") * n, n, cache_len


def _rank_block(t: torch.Tensor, spec: Tuple, mesh,
                global_batch: int) -> torch.Tensor:
    """This rank's block of a cache leaf under ``spec``: its batch rows
    (``batch_rows``), its slice of each dim on ``model`` and its
    positions under the sequence cut."""
    idx = list(local_slices(tuple(a if a in ("model", "data") else None
                                  for a in spec), t.shape, mesh))
    if len(spec) > 1 and spec[1] is not None:
        idx[1] = batch_rows(mesh, global_batch)
    return t[tuple(idx)]


def local_cache(cfg, batch: int, max_len: int, dtype, device, mesh
                ) -> dict:
    """This rank's zeroed contiguous cache (``init_cache``, or ``{"b0":
    init_encdec_cache(...)}`` for an encoder-decoder): its rows of a
    global ``batch`` (all of them where ``batch`` does not divide the dp
    axes) at the rank's head counts (``layers.rank_config``), and its
    ``T / D`` positions of the ``max_len`` under the sequence cut
    (``seq_slice``)."""
    lcfg = rank_config(cfg, meshlib.axis_size(mesh, "model"))
    rows = (batch // meshlib.dp_size(mesh) if batch_spec(mesh, batch)
            else batch)
    cut = seq_slice(mesh, batch, max_len)
    t = cut[1] if cut is not None else max_len
    if cfg.is_encdec:
        return {"b0": KV.init_encdec_cache(lcfg, rows, t, dtype, device)}
    return KV.init_cache(lcfg, rows, t, dtype, device)


def shard_cache(cache: dict, mesh, global_batch: int, cfg=None) -> dict:
    """This rank's slice of a whole contiguous cache (``cache_spec``),
    copied."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        spec = cache_spec(path, tree, mesh, global_batch, cfg)
        return _rank_block(tree, spec, mesh, global_batch).clone()
    return walk(cache, "")


def logits_spec(mesh, global_batch: int, cfg=None) -> Tuple:
    """``[B, S, V]`` logits (JAX's ``logits_spec``): the batch on the dp
    axes where it divides, the vocab on ``model`` (with ``cfg``, only
    where the vocab divides it: a head whose vocab does not replicates,
    ``serve.steps.logits2d``)."""
    tp_n = meshlib.axis_size(mesh, "model")
    v_ax = ("model" if "model" in mesh.axis_names and (
        cfg is None or cfg.vocab % tp_n == 0) else None)
    b_ax = _dp_entry(mesh) if batch_spec(mesh, global_batch) else None
    return (b_ax, None, v_ax)


# ---------------------------------------------------------------------------
# training: FSDP on data, TP on model, the batch over (pod, data)
# ---------------------------------------------------------------------------
# leaves whose gradient is partial over model: the column-parallel
# biases (each rank adds its slice) and the MoE router (each rank's gates
# combine only its experts or hidden units)
_MODEL_PARTIAL = r"attn/b[qkv]$|ffn/router$"


def check_train_mesh(cfg, mesh) -> None:
    """Refuse a model the training mesh does not run: a ``d_ff`` that does
    not divide the model axis (its FFN's column cut would replicate, and
    its row-parallel ``w_down`` would then need a model sum of its own;
    no registry config has one). Every other stack trains: dense,
    local/global attention, MoE (EP or the Megatron fallback), Mamba2,
    hybrid, encoder-decoder and VLM; heads that do not divide ``model``
    replicate the attention block over it, and a vocab that does not
    divide it replicates the embedding and the head."""
    if mesh is None:
        raise ValueError("the sharded step needs a mesh; one device trains "
                         "with train.step.single_device_step")
    m = meshlib.axis_size(mesh, "model")
    if cfg.d_ff % m:
        raise ValueError(
            f"{cfg.name}: d_ff = {cfg.d_ff} does not divide the model axis "
            f"({m}): the FFN's column cut would replicate while its "
            f"row-parallel w_down needs a model sum of its own")


def train_specs(params, mesh, cfg=None) -> dict:
    """``{path: spec}`` of a whole parameter tree (``param_spec``, with
    ``cfg`` for the heads; a ``meta`` tree of the shapes will do)."""
    return {path: param_spec(path, leaf, mesh, cfg)
            for path, leaf in T.items(params)}


def train_slices(params, mesh, specs: Optional[dict] = None):
    """This rank's slice of every leaf of a whole tree, copied (the whole
    tree can be freed)."""
    specs = specs if specs is not None else train_specs(params, mesh)
    out = []
    for path, leaf in T.items(params):
        idx = local_slices(specs[path], leaf.shape, mesh)
        out.append(leaf[idx].clone(memory_format=torch.contiguous_format))
    return T.unflatten(params, out)


def _sharded_dims(spec: Tuple, mesh):
    """``(dim, axis)`` of each dim ``spec`` cuts over an axis of size
    > 1."""
    return [(i, ax) for i, ax in enumerate(spec)
            if ax is not None and meshlib.axis_size(mesh, ax) > 1]


def fsdp_gather(specs: dict, mesh):
    """``gather(tree, prefix)``: ``tree`` (the leaves under ``prefix``,
    or one group's slice of them) with each leaf made whole along its
    ``data`` dim, through ``collectives.gather_over`` (a reduce-scatter of
    its gradient in the backward pass)."""
    def gather(tree, prefix: str):
        out = []
        for path, leaf in T.items(tree, (prefix,)):
            spec = specs[path]
            if len(spec) == leaf.ndim + 1:        # one group of a stack
                spec = spec[1:]
            for dim, ax in _sharded_dims(spec, mesh):
                if ax == "data":
                    leaf = C.gather_over(leaf, mesh, dim)
            out.append(leaf)
        return T.unflatten(tree, out)
    return gather


def grad_axes(path: str, spec: Tuple, mesh, cfg=None) -> Tuple[str, ...]:
    """The axes this leaf's gradient is summed over after the backward
    pass: ``data`` where the leaf is replicated over it, ``model`` for
    the column-parallel biases and the MoE router, ``pod`` always. A
    replicated attention block (``cfg``'s heads do not divide ``model``)
    runs whole on every model rank, so its biases' gradients are whole
    there and take no SUM over ``model``."""
    out = []
    if "data" not in spec and meshlib.axis_size(mesh, "data") > 1:
        out.append("data")
    if re.search(_MODEL_PARTIAL, path) \
            and meshlib.axis_size(mesh, "model") > 1 \
            and not replicated_attn_leaf(path, cfg, mesh):
        out.append("model")
    if meshlib.axis_size(mesh, "pod") > 1:
        out.append("pod")
    return tuple(out)


def restore_slicer(mesh, spec_fn=None, cfg=None) -> Callable:
    """``slice_fn(path, whole array)`` for ``checkpoint.ckpt.restore``:
    this rank's block of a leaf on disk under ``spec_fn(path, array,
    mesh)`` (``param_spec`` by default; ``cfg`` goes to it as a keyword,
    for the heads)."""
    spec_fn = spec_fn or param_spec
    kw = {} if cfg is None else {"cfg": cfg}

    def slice_fn(path: str, arr):
        return arr[local_slices(spec_fn(path, arr, mesh, **kw), arr.shape,
                                mesh)]
    return slice_fn


def owns(spec: Tuple, mesh) -> bool:
    """Whether this rank counts its slice of a leaf in a global sum: it
    sits at index 0 of every axis the leaf is replicated over."""
    return all(mesh.index(ax) == 0 for ax in mesh.axis_names
               if ax not in spec and meshlib.axis_size(mesh, ax) > 1)


def unshard(tree, mesh, specs: dict, keep: bool = True):
    """The whole leaves of a tree of this rank's slices, gathered leaf by
    leaf over each axis that cuts them (every rank must call it);
    ``keep=False`` drops them (a rank that does not write the
    checkpoint)."""
    out = []
    with torch.no_grad():
        for path, leaf in T.items(tree):
            for dim, ax in _sharded_dims(specs[path], mesh):
                leaf = mesh.all_gather(leaf, ax, dim, kind="unshard")
            out.append(leaf if keep else None)
    return T.unflatten(tree, out) if keep else None


def _dp_entry(mesh):
    """dp axes as a spec entry: the name for a single axis, a tuple for
    ``(pod, data)``."""
    dp = meshlib.dp_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def batch_spec(mesh, global_batch: int) -> Tuple:
    """The global batch's spec: over the dp axes when it divides them,
    else replicated (``()``)."""
    dp = _dp_entry(mesh)
    if global_batch % meshlib.dp_size(mesh) == 0 and dp:
        return (dp,)
    return ()


def batch_rows(mesh, global_batch: int, microbatches: int = 1):
    """This rank's rows of the global batch under ``batch_spec``: the dp
    axes flattened ``pod``-major, as JAX lays a tuple entry out. With
    ``microbatches > 1`` (dividing the rank's rows) the rank's share of
    each of the global batch's consecutive ``microbatches`` chunks, in
    chunk order (a list of row indices), so the rank's own split into
    ``microbatches`` pieces is its share of the reference's."""
    if not batch_spec(mesh, global_batch):
        return slice(None)
    k = meshlib.dp_index(mesh)
    n = global_batch // meshlib.dp_size(mesh)
    if microbatches <= 1 or n % microbatches or n == global_batch:
        return slice(k * n, (k + 1) * n)
    chunk, part = global_batch // microbatches, n // microbatches
    return [i * chunk + k * part + j for i in range(microbatches)
            for j in range(part)]
