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

from repro_torch.models.layers import _ACTS, linear, matmul_any


def capacity(t: int, cfg) -> int:
    """Rows per expert for a call over ``t`` token rows."""
    cap = int(math.ceil(t * cfg.topk / cfg.n_experts * cfg.capacity_factor))
    return max(cap, cfg.topk)


def _experts(buf: torch.Tensor, w, use_kernels: bool) -> torch.Tensor:
    """``[E, cap, din] @ w[e]`` for every expert: one ``bmm`` over a dense
    ``[E, din, dout]`` stack, or one qmm per expert over a list of
    QTensors."""
    if isinstance(w, torch.Tensor):
        return torch.bmm(buf, w.to(buf.dtype))
    return torch.stack([matmul_any(buf[e], w[e], use_kernels)
                        for e in range(len(w))])


def moe_block(p: dict, x: torch.Tensor, cfg, *, use_kernels: bool = True,
              tap=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux_loss fp32 scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.topk
    cap = capacity(t, cfg)
    dev = x.device

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

    # sort-based dispatch: each assignment's position within its expert
    flat_expert = expert_ids.reshape(-1)                     # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = order // k                                          # token ids
    starts = torch.searchsorted(se, experts)
    seg_pos = torch.arange(t * k, device=dev) - starts[se]
    keep = seg_pos < cap
    slot = torch.where(keep, se * cap + seg_pos,
                       torch.full_like(seg_pos, e * cap))    # spare row
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf.index_copy_(0, slot, xf[st])
    buf = buf[:e * cap].reshape(e, cap, d)

    # grouped expert FFN
    act = _ACTS[cfg.act]
    if cfg.gated_mlp:
        h = act(_experts(buf, p["w_gate"], use_kernels)) \
            * _experts(buf, p["w_up"], use_kernels)
    else:
        h = act(_experts(buf, p["w_up"], use_kernels))
    y_buf = _experts(h, p["w_down"], use_kernels).reshape(e * cap, d)

    # combine: every assignment's row back in (token, choice) order, then
    # each token's k contributions summed in ascending expert id
    unsorted = torch.empty_like(slot)
    unsorted[order] = torch.where(keep, slot, torch.zeros_like(slot))
    kept = torch.empty_like(keep)
    kept[order] = keep
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
    return y.reshape(b, s, d), aux
