"""Mixture-of-Experts FFN with sort-based capacity dispatch (counterpart of
``repro.models.moe``).

Tokens are sorted by assigned expert (stable), scattered into an ``[E,
cap, d]`` buffer, run through each expert's FFN and combined back with
the router gates. ``cap = max(ceil(T * k / E * capacity_factor), k)``
counts every row of ``x`` (``T = B * S``, idle lanes and padding
included), so a token's output depends on how many rows share its call,
as in the reference (GShard semantics): assignments past an expert's
capacity are dropped. The Switch load-balancing loss comes back beside
the output.

The expert products: a dense ``[E, d, ff]`` stack goes through one
``torch.bmm``; a per-expert list of QTensors (the serving format) runs
expert ``e``'s ``[cap, d]`` rows through ``kernels.ops.qmm`` against its
own streams (the qmm kernels on the card), where the reference
dequantizes the stack on every call.

On a serving mesh (``runtime_context.use_mesh``; the weights cut by
``launch.sharding``) every model rank routes every row it runs on the
replicated router and dispatches with one process's capacity: where the
step's lanes split over ``data`` the block is global over the data
ranks' rows, as below for training, and where every rank runs every
lane ``capacity`` counts the same rows. Each expert's qmm plans its
route on that capacity, whatever share of it a rank runs. Under expert
parallelism (``E % M == 0``) a rank holds experts ``[m E/M, (m + 1)
E/M)`` whole (a ``[E]`` QTensor list with ``None`` elsewhere, or a dense
``[E/M, d, ff]`` stack), dispatches only the assignments to its
experts, runs only their rows and combines only their contributions;
under the Megatron fallback it holds its slice of every expert's hidden
units (a whole expert's output is cut to that slice before ``w_down``)
and its combine is a partial sum. Either way one all_reduce SUM over ``model``
(kind ``moe``) per layer completes ``y``, in place of the dense FFN's
``w_down`` sum; no all-to-all (and, off a row split, nothing is read
back to the host).
Rank ``m``'s experts are ids above rank ``m - 1``'s, so the sum groups
the one-process combine's ascending terms by rank.

On a training mesh (``train.step.mesh_grads_fn``) the same layout
carries gradients. The layer is partial over ``model`` (EP or the
fallback), so ``x`` enters through ``layers.tp_input``, whose backward
sums the ranks' partial ``dx`` (each rank dispatches and combines only
its experts or hidden units). The router runs replicated; the part of
its gradient that comes through the gates is partial in the same way,
while the load-balancing loss is whole on every model rank, so only
model rank 0 takes the aux loss's gradient (the others take its value
alone): the router's and ``dx``'s partial gradients then sum over
``model`` to one process's (``launch.sharding.grad_axes`` sums the
router's). When the batch's rows are split over the dp axes
(``runtime_context.current_row_axes``) the block is global over them,
as the reference's is over the whole batch: the capacity counts every
dp rank's rows; the drops follow one stable sort over the global rows,
laid out rank-major (``launch.sharding.batch_rows``, ``launch.mesh.
dp_index``), which no token
needs to cross ranks for: each dp rank adds to an assignment's position
in its expert the assignments to that expert on the dp ranks before it;
and the load-balancing loss takes the router's probability mass and the
top-1 counts summed over the dp ranks. One ``moe_dp`` all_reduce over
each dp axis a layer carries those sums and the per-rank assignment
counts (``collectives.sum_dp``). Each rank runs only its kept rows: its
expert buffer holds, per expert, as many rows as it keeps for the
busiest of its experts (read to the host once a layer). One process, or
rows not split over dp, keeps the one-process code.

``record_routes()`` collects, for every call, the expert ids, the kept
mask over the global capacity and the smallest top-k margin of the
router's probabilities (a check that a mesh routes as one process does).

Everything is a fixed-shape tensor op: nothing reads the device from the
host, so a CUDA graph of the serving step can hold it. The combine sums
each token's k contributions in ascending expert id, starting from zero
(the order of the reference's sorted scatter-add), so eager and graphed
runs give the same bits; the dispatch writes each kept assignment to its
own row and dropped ones to a spare row that is cut off. (The global
capacity's buffer size is read to the host: rows split over dp only,
whose mesh steps run eagerly.)
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

from repro_torch import runtime_context as ctx
from repro_torch.kernels import ops as kops
from repro_torch.launch import collectives as C
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.sharding import expert_range
from repro_torch.models.layers import (_ACTS, _tp_local, linear, tp_input,
                                       tp_size)

_ROUTES: Optional[list] = None


@contextlib.contextmanager
def record_routes():
    """A list that every ``moe_block`` call inside the block appends
    ``{"ids" [T, k], "kept" [T, k], "margin"}`` to (on the CPU)."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def capacity(t: int, cfg) -> int:
    """Rows per expert for a call over ``t`` token rows."""
    cap = int(math.ceil(t * cfg.topk / cfg.n_experts * cfg.capacity_factor))
    return max(cap, cfg.topk)


def _ff_rows(w, first: int) -> int:
    """Input rows of an expert's ``w_down`` on this rank."""
    return w[first].shape[0] if isinstance(w, list) else w.shape[1]


def _experts(buf: torch.Tensor, w, use_kernels: bool, first: int,
             cap: int) -> torch.Tensor:
    """``[n, cap_b, din] @ w[first + i]`` for each of the ``n`` experts
    this rank holds: one ``bmm`` over a dense ``[n, din, dout]`` stack, or
    one qmm per expert over a list of QTensors, its route planned on the
    call's capacity ``cap`` (one process's rows an expert, whatever
    ``cap_b`` a rank of a row split runs)."""
    if isinstance(w, torch.Tensor):
        return torch.bmm(buf, w.to(buf.dtype))
    return torch.stack([kops.qmm(buf[i], w[first + i], use_kernels,
                                 plan_m=cap)
                        for i in range(buf.shape[0])])


def moe_block(p: dict, x: torch.Tensor, cfg, *, use_kernels: bool = True,
              tap=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux_loss fp32 scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.topk
    dev = x.device
    mesh = ctx.current_mesh()
    axes = ctx.current_row_axes()
    dp_k, dp_n = ((meshlib.dp_index(mesh), meshlib.dp_size(mesh)) if axes
                  else (0, 1))
    cap = capacity(t * dp_n, cfg)
    first, stop = expert_range(e, mesh)
    n = stop - first
    ff_rows = _ff_rows(p["w_down"], first)
    # the layer's y is partial on this rank: some experts elsewhere (EP),
    # or each expert's hidden units cut (the Megatron fallback)
    partial = tp_size() > 1 and (n < e or ff_rows != cfg.d_ff)

    xf = x.reshape(t, d)
    if partial:
        xf = tp_input(xf)
    if tap:
        tap("router", xf)
    logits = linear(xf, p["router"], use_kernels=use_kernels
                    ).to(torch.float32)                      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)     # [T, k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    # sort-based dispatch: each assignment's position within its expert
    flat_expert = expert_ids.reshape(-1)                     # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = order // k                                          # token ids
    experts = torch.arange(e, device=dev)
    starts = torch.searchsorted(se, experts)
    seg_pos = torch.arange(t * k, device=dev) - starts[se]
    top1 = (expert_ids[:, :1] == experts).to(torch.float32)  # [T, E]

    # Switch-style load-balancing loss; over dp, of the global rows: the
    # probability mass, the top-1 counts and each rank's assignment
    # counts summed over the dp ranks in one buffer
    if dp_n == 1:
        me, ce = probs.mean(dim=0), top1.mean(dim=0)
        keep, cap_b = seg_pos < cap, cap
    else:
        counts = torch.zeros((dp_n, e), dtype=torch.float32, device=dev)
        # a shape-static count (bincount's size depends on the data)
        counts[dp_k] = torch.zeros(e, device=dev).index_add_(
            0, flat_expert, torch.ones(t * k, device=dev))
        stats = C.sum_dp(torch.cat([probs.sum(dim=0), top1.sum(dim=0),
                                    counts.reshape(-1)]), mesh, axes)
        me, ce = stats[:e] / (t * dp_n), stats[e:2 * e] / (t * dp_n)
        counts = stats[2 * e:].detach().reshape(dp_n, e).to(torch.int64)
        before = counts[:dp_k].sum(dim=0)                    # [E]
        keep = seg_pos + before[se] < cap
        # this rank's kept rows of its busiest expert
        kept_rows = torch.clamp(cap - before, min=0).minimum(counts[dp_k])
        # shapes only in the dry run (meta): the bound, not the routing
        cap_b = (cap if dev.type == "meta"
                 else max(1, int(kept_rows[first:stop].max())))
    aux = (me * ce).sum() * e
    if partial and mesh.index("model") != 0:
        aux = aux.detach()                # its gradient on model rank 0
    if _ROUTES is not None:
        _record(probs, expert_ids, keep, order, k)

    # the kept assignments to this rank's experts get rows [0, n * cap_b)
    rows = n * cap_b
    row = (se - first) * cap_b + seg_pos
    own = keep & (se >= first) & (se < first + n)
    slot = torch.where(own, row, torch.full_like(row, rows))  # spare row
    buf = torch.zeros((rows + 1, d), dtype=x.dtype, device=dev)
    buf.index_copy_(0, slot, xf[st])
    buf = buf[:rows].reshape(n, cap_b, d)
    # grouped expert FFN over this rank's experts (or hidden units)
    act = _ACTS[cfg.act]

    def hidden(name):
        # under the fallback a whole expert's hidden units before a cut
        # w_down are cut to the rank's slice; never the reverse: an
        # (8, 128) subtile grid cuts w_up's columns only where it cuts
        # w_down's rows too
        h = _experts(buf, p[name], use_kernels, first, cap)
        return _tp_local(h) if h.shape[-1] != ff_rows else h
    if cfg.gated_mlp:
        h = act(hidden("w_gate")) * hidden("w_up")
    else:
        h = act(hidden("w_up"))
    y_buf = _experts(h, p["w_down"], use_kernels, first, cap).reshape(
        rows, d)

    # combine: every assignment's row back in (token, choice) order, then
    # each token's k contributions summed in ascending expert id
    unsorted = torch.empty_like(slot)
    unsorted[order] = torch.where(own, slot, torch.zeros_like(slot))
    kept = torch.empty_like(own)
    kept[order] = own
    gathered = y_buf[unsorted].reshape(t, k, d)
    gates = gate_vals.to(x.dtype)[..., None]
    contrib = torch.where(kept.reshape(t, k, 1), gathered * gates,
                          torch.zeros_like(gathered))
    by_expert = torch.argsort(expert_ids, dim=-1)            # [T, k]
    contrib = torch.gather(contrib, 1,
                           by_expert[..., None].expand(t, k, d))
    y = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + contrib[:, j]
    if partial:
        y = C.sum_over(y, mesh, kind="moe")
    return y.reshape(b, s, d), aux


def _record(probs, expert_ids, keep, order, k: int) -> None:
    """One call's routing into ``record_routes``'s list."""
    kept = torch.empty_like(keep)
    kept[order] = keep
    e = probs.shape[-1]
    margin = float("inf")
    if k < e and probs.shape[0]:
        top = torch.topk(probs.detach(), k + 1, dim=-1).values
        margin = float((top[:, k - 1] - top[:, k]).min())
    _ROUTES.append({"ids": expert_ids.detach().cpu(),
                    "kept": kept.reshape(-1, k).cpu(), "margin": margin})
