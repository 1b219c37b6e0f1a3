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
``launch.sharding``) every model rank routes every row on the replicated
router and dispatches with one process's capacity (every rank runs every
lane, so ``capacity`` counts the same rows). Under expert parallelism
(``E % M == 0``) a rank holds experts ``[m E/M, (m + 1) E/M)`` whole
(a ``[E]`` QTensor list with ``None`` elsewhere, or a dense ``[E/M, d,
ff]`` stack), dispatches only the assignments to its experts, runs only
their rows and combines only their contributions; under the Megatron
fallback it holds its slice of every expert's hidden units (a whole
expert's output is cut to that slice before ``w_down``) and its
combine is a partial sum. Either way one all_reduce SUM over ``model``
(kind ``moe``) per layer completes ``y``, in place of the dense FFN's
``w_down`` sum; no all-to-all, and nothing is read back to the host.
Rank ``m``'s experts are ids above rank ``m - 1``'s, so the sum groups
the one-process combine's ascending terms by rank.

Everything is a fixed-shape tensor op: nothing reads the device from the
host, so a CUDA graph of the serving step can hold it. The combine sums
each token's k contributions in ascending expert id, starting from zero
(the order of the reference's sorted scatter-add), so eager and graphed
runs give the same bits; the dispatch writes each kept assignment to its
own row and dropped ones to a spare row that is cut off.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import runtime_context as ctx
from repro_torch.launch import collectives as C
from repro_torch.launch.sharding import expert_range
from repro_torch.models.layers import (_ACTS, _tp_local, linear, matmul_any,
                                       tp_size)


def capacity(t: int, cfg) -> int:
    """Rows per expert for a call over ``t`` token rows."""
    cap = int(math.ceil(t * cfg.topk / cfg.n_experts * cfg.capacity_factor))
    return max(cap, cfg.topk)


def _ff_rows(w, first: int) -> int:
    """Input rows of an expert's ``w_down`` on this rank."""
    return w[first].shape[0] if isinstance(w, list) else w.shape[1]


def _experts(buf: torch.Tensor, w, use_kernels: bool,
             first: int) -> torch.Tensor:
    """``[n, cap, din] @ w[first + i]`` for each of the ``n`` experts this
    rank holds: one ``bmm`` over a dense ``[n, din, dout]`` stack, or one
    qmm per expert over a list of QTensors."""
    if isinstance(w, torch.Tensor):
        return torch.bmm(buf, w.to(buf.dtype))
    return torch.stack([matmul_any(buf[i], w[first + i], use_kernels)
                        for i in range(buf.shape[0])])


def moe_block(p: dict, x: torch.Tensor, cfg, *, use_kernels: bool = True,
              tap=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux_loss fp32 scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.topk
    cap = capacity(t, cfg)
    dev = x.device
    first, stop = expert_range(e, ctx.current_mesh())
    n = stop - first
    ff_rows = _ff_rows(p["w_down"], first)
    # the layer's y is partial on this rank: some experts elsewhere (EP),
    # or each expert's hidden units cut (the Megatron fallback)
    partial = tp_size() > 1 and (n < e or ff_rows != cfg.d_ff)

    xf = x.reshape(t, d)
    if tap:
        tap("router", xf)
    logits = linear(xf, p["router"], use_kernels=use_kernels
                    ).to(torch.float32)                      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)     # [T, k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    # Switch-style load-balancing loss
    me = probs.mean(dim=0)
    experts = torch.arange(e, device=dev)
    ce = (expert_ids[:, :1] == experts).to(torch.float32).mean(dim=0)
    aux = (me * ce).sum() * e

    # sort-based dispatch: each assignment's position within its expert;
    # the kept assignments to this rank's experts get rows [0, n * cap)
    flat_expert = expert_ids.reshape(-1)                     # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = order // k                                          # token ids
    starts = torch.searchsorted(se, experts)
    seg_pos = torch.arange(t * k, device=dev) - starts[se]
    rows = n * cap
    row = (se - first) * cap + seg_pos
    own = (seg_pos < cap) & (se >= first) & (se < first + n)
    slot = torch.where(own, row, torch.full_like(row, rows))  # spare row
    buf = torch.zeros((rows + 1, d), dtype=x.dtype, device=dev)
    buf.index_copy_(0, slot, xf[st])
    buf = buf[:rows].reshape(n, cap, d)

    # grouped expert FFN over this rank's experts (or hidden units)
    act = _ACTS[cfg.act]

    def hidden(name):
        # under the fallback a whole expert's hidden units before a cut
        # w_down are cut to the rank's slice; never the reverse: an
        # (8, 128) subtile grid cuts w_up's columns only where it cuts
        # w_down's rows too
        h = _experts(buf, p[name], use_kernels, first)
        return _tp_local(h) if h.shape[-1] != ff_rows else h
    if cfg.gated_mlp:
        h = act(hidden("w_gate")) * hidden("w_up")
    else:
        h = act(hidden("w_up"))
    y_buf = _experts(h, p["w_down"], use_kernels, first).reshape(rows, d)

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
        y = C.sum_over(y, ctx.current_mesh(), kind="moe")
    return y.reshape(b, s, d), aux
