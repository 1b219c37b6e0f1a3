"""Primitive layers: norms, linears (dense or QTensor), rotary embeddings
(counterpart of ``repro.models.layers``).

``matmul_any`` is the one dispatch point where QMC stream weights enter
the forward pass: a :class:`QTensor` goes through ``kernels.ops.qmm`` (the
qmm kernels on the card), a dense tensor through ``torch.matmul``, and a
:class:`ShardedQTensor` as JAX dispatches it: TP-local under a mesh whose
model axis has its shard count, ``kernels.ops.qmm`` at one shard, the
oracle ``qmm_sharded_ref`` otherwise.

Tensor parallelism (under ``runtime_context.use_mesh``): a rank runs its
slice of the heads, of the FFN's hidden units and of the vocab.
``column_linear`` returns the rank's slice of a projection's outputs (a
replicated weight's whole output is cut to it), ``row_linear`` takes the
rank's slice of the inputs and sums the partial products over the model
group (a replicated weight takes the whole input, gathered), and
``embed_tokens`` looks a vocab-sharded table up on the rank that holds
each token, summed over the model group. ``gathered_linear`` (the Mamba2
``in_proj``, whose output splits at boundaries the column cut does not
respect) makes a column-parallel product's outputs whole again right
after it (``tp_gather``). Off a mesh all four are the plain ops.
Where a dim does not divide the model axis its weight is whole on every
rank and its consumer runs whole: ``embed_tokens`` and
``cross_entropy_loss`` read a whole vocab off the table's and the
logits' width, and an attention block whose heads do not divide
(``attn_replicated``) runs every head through plain ``linear``, outside
``tp_input``, whose backward would sum the ranks' whole input gradients
into M times the true one.

Training on a mesh takes gradients through the same code: the sums over
the model group are ``launch.collectives.sum_over`` (in place, as
before, when nothing needs a gradient) and ``tp_input`` marks a
column-parallel input, whose gradient is summed over the model group in
the backward pass. ``tp_gather`` is ``collectives.gather_model`` (its
backward keeps the rank's slice of a gradient the replicated consumer
made whole) and ``row_linear`` cuts a replicated input with
``collectives.split_model`` (its backward gathers the slices'
gradients), so a mixer that runs replicated between them (the Mamba2
mixer) gets whole gradients on every model rank; off the graph both are
serving's all_gather and plain slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import runtime_context as ctx
from repro_torch.core.qtensor import QTensor
from repro_torch.core.qtensor_sharded import (ShardedQTensor, qmm_shard,
                                              qmm_sharded_ref)
from repro_torch.kernels import ops as kops
from repro_torch.launch import collectives as C


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(dt)


def matmul_any(x: torch.Tensor, w, use_kernels: bool = True
               ) -> torch.Tensor:
    """x @ w where w is dense, a QTensor or a ShardedQTensor (QMC
    serving)."""
    if isinstance(w, ShardedQTensor):
        mesh = ctx.current_mesh()
        if mesh is not None and w.n_shards == tp_size():
            return qmm_shard(x, w, mesh, use_kernels=use_kernels)
        if w.n_shards == 1:
            return kops.qmm(x, w.local(w.first), use_kernels=use_kernels)
        return qmm_sharded_ref(x, w)
    if isinstance(w, QTensor):
        return kops.qmm(x, w, use_kernels=use_kernels)
    return torch.matmul(x, w.to(x.dtype))


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
           use_kernels: bool = True) -> torch.Tensor:
    y = matmul_any(x, w, use_kernels=use_kernels)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def tp_size() -> int:
    """The model axis of the current mesh (1 off a mesh)."""
    mesh = ctx.current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.devices.shape[list(mesh.axis_names).index("model")]


def attn_replicated(cfg, m: Optional[int] = None) -> bool:
    """Whether attention runs whole on every one of ``m`` model ranks (the
    current mesh's by default): where the heads or the KV heads do not
    divide ``m`` the block's leaves replicate over ``model``
    (``launch.sharding.param_spec`` with ``cfg``), so every rank runs
    every head, with ``wo`` whole and no sum."""
    m = tp_size() if m is None else m
    return m > 1 and bool(cfg.n_heads % m or cfg.n_kv_heads % m)


def rank_config(cfg, m: Optional[int] = None):
    """``cfg`` with the heads an attention block runs on one of ``m``
    model ranks (the current mesh's by default): ``1 / m`` of the query
    and KV heads under TP, all of them off a mesh or where the block
    replicates (``attn_replicated``). A rank's KV cache or arena is
    allocated at these counts."""
    m = tp_size() if m is None else m
    if m == 1 or attn_replicated(cfg, m):
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // m,
                               n_kv_heads=cfg.n_kv_heads // m)


def tp_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering column-parallel projections (or a vocab-sharded
    head): the identity forward, its gradient summed over the model
    group in the backward pass (nothing off a mesh or off the graph)."""
    if tp_size() == 1:
        return x
    return C.copy_to(x, ctx.current_mesh())


def _tp_local(x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the last dim of ``x``."""
    n = x.shape[-1] // tp_size()
    m = ctx.current_mesh().index("model")
    return x[..., m * n:(m + 1) * n]


def tp_gather(x: torch.Tensor, full: int, dim: int = -1) -> torch.Tensor:
    """The whole ``dim`` from every rank's equal slice of it: one
    all_gather over the model group (kind ``gather``; on the autograd
    graph its backward keeps this rank's slice of the gradient)."""
    if x.shape[dim] * tp_size() != full:
        raise ValueError(f"a slice of {x.shape[dim]} does not make {full} "
                         f"over {tp_size()} model ranks")
    return C.gather_model(x, ctx.current_mesh(), dim)


def gathered_linear(x: torch.Tensor, w, use_kernels: bool,
                    full: int) -> torch.Tensor:
    """``x @ w`` with all ``full`` outputs on every rank: a column-parallel
    weight's slice of them made whole (``tp_gather``; ``x`` enters
    through ``tp_input``); a replicated weight, or no mesh, gives them as
    they are."""
    if isinstance(w, torch.Tensor) and w.shape[-1] != full:
        x = tp_input(x)
    y = matmul_any(x, w, use_kernels=use_kernels)
    if y.shape[-1] != full:
        y = tp_gather(y, full)
    return y


def column_linear(x: torch.Tensor, w, b: Optional[torch.Tensor],
                  use_kernels: bool, full: int) -> torch.Tensor:
    """A column-parallel projection with ``full`` outputs: this rank's
    slice of them (all of them off a mesh)."""
    if tp_size() == 1:
        return linear(x, w, b, use_kernels)
    y = matmul_any(x, w, use_kernels=use_kernels)
    if y.shape[-1] == full:                   # a replicated weight
        y = _tp_local(y)
    if b is not None:
        y = y + (_tp_local(b) if b.shape[-1] == full else b).to(y.dtype)
    return y


def row_linear(x: torch.Tensor, w, b: Optional[torch.Tensor],
               use_kernels: bool, full_in: int) -> torch.Tensor:
    """A row-parallel projection over ``full_in`` inputs: the rank's slice
    of them (cut from a whole ``x`` by ``collectives.split_model``) times
    its rows of ``w``, summed over the model group (off a mesh, the plain
    projection)."""
    n = tp_size()
    if n == 1:
        return linear(x, w, b, use_kernels)
    if isinstance(w, ShardedQTensor):
        rows = w.shape[0] // (n if w.n_shards == n else 1)
    else:
        rows = w.shape[0]
    if rows == full_in:                       # a replicated weight
        if x.shape[-1] != full_in:
            x = tp_gather(x, full_in)
        y = matmul_any(x, w, use_kernels=use_kernels)
    else:
        if x.shape[-1] == full_in:
            x = C.split_model(x, ctx.current_mesh(), -1)
        y = matmul_any(x, w, use_kernels=use_kernels)
        if not isinstance(w, ShardedQTensor):     # qmm_shard reduces
            y = C.sum_over(y, ctx.current_mesh())
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def rotary_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions [..., S] -> fp32 (cos, sin) of shape [..., S, dim//2]."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 rotary_pct: float = 1.0) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D_rot//2]. The rotated part is split
    into two halves (not interleaved pairs); partial rotary keeps the
    tail of each head as is."""
    d = x.shape[-1]
    d_rot = int(d * rotary_pct) // 2 * 2
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = torch.chunk(xr, 2, dim=-1)
    c = cos[..., None, : d_rot // 2]
    s = sin[..., None, : d_rot // 2]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor,
                 scale: bool = False, vocab: Optional[int] = None
                 ) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``. Under a mesh, a table holding a
    slice of the ``vocab`` rows gives each token's row on the rank that
    holds it and zeros elsewhere, summed over the model group."""
    if vocab is not None and table.shape[0] != vocab and tp_size() > 1:
        mesh = ctx.current_mesh()
        local = tokens - mesh.index("model") * table.shape[0]
        own = (local >= 0) & (local < table.shape[0])
        x = table[torch.where(own, local, torch.zeros_like(local))]
        x = C.sum_over(torch.where(own[..., None], x, torch.zeros_like(x)),
                       mesh)
    else:
        x = table[tokens]
    if scale:
        x = x * torch.full((), table.shape[1] ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


_ACTS = {"silu": F.silu,
         "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu
         "relu": F.relu}


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       vocab: Optional[int] = None) -> torch.Tensor:
    """Mean token NLL in fp32 (``repro.models.layers.cross_entropy_loss``):
    logits ``[B, S, V]``, labels ``[B, S]`` integer; with ``mask`` the
    masked mean, its denominator at least 1. Under a mesh, logits holding
    this rank's slice of the ``vocab`` columns take the vocab-parallel
    reductions (``vocab_parallel_nll``)."""
    logits = logits.to(torch.float32)
    if vocab is not None and logits.shape[-1] != vocab and tp_size() > 1:
        nll = vocab_parallel_nll(logits, labels, ctx.current_mesh())
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long()
                            ).squeeze(-1)
        nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       mesh) -> torch.Tensor:
    """``logsumexp - gold`` per token of fp32 ``logits [..., V/M]``, this
    rank's slice of the vocab (rank ``m`` holds columns ``[m V/M, (m + 1)
    V/M)``), equal on every model rank: the row max is a MAX over the
    model group (no gradient: the loss does not depend on it), the
    exponent sum and the gold logit (picked by an arithmetic label mask)
    one SUM of both over the model group."""
    n = logits.shape[-1]
    col = mesh.index("model") * n + torch.arange(n, device=logits.device)
    m = C.max_over(logits.amax(dim=-1), mesh)
    hit = labels[..., None].long() == col
    parts = torch.stack([
        torch.exp(logits - m[..., None]).sum(dim=-1),
        torch.where(hit, logits, torch.zeros_like(logits)).sum(dim=-1)])
    se, gold = C.sum_over(parts, mesh, kind="loss").unbind(0)
    return m + torch.log(se) - gold


def glu_mlp(x: torch.Tensor, p: dict, act: str = "silu", gated: bool = True,
            use_kernels: bool = True, tap=None,
            d_ff: Optional[int] = None) -> torch.Tensor:
    """The (gated) MLP; with ``d_ff`` (the whole hidden width) its
    projections are tensor-parallel under a mesh."""
    actf = _ACTS[act]
    if tap:
        tap("w_up", x)
    if d_ff is not None:
        x = tp_input(x)

    def up(name):
        if d_ff is None:
            return linear(x, p[name], use_kernels=use_kernels)
        return column_linear(x, p[name], None, use_kernels, d_ff)
    if gated:
        h = actf(up("w_gate")) * up("w_up")
    else:
        h = actf(up("w_up"))
    if tap:
        tap("w_down", h)
    if d_ff is None:
        return linear(h, p["w_down"], use_kernels=use_kernels)
    return row_linear(h, p["w_down"], None, use_kernels, d_ff)
