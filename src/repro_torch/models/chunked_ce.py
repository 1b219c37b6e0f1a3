"""Vocab-chunked fused lm_head + cross-entropy, and the gather-free
single-device CE (counterpart of ``repro.models.chunked_ce``).

``chunked_ce_loss`` walks the vocab in chunks with an online logsumexp and
regenerates each chunk's logits in the backward, so neither pass holds a
``[T, V]`` array: peak residency is ``O(T * chunk)``. It is a
``torch.autograd.Function`` whose forward and backward follow the
reference's ``_fwd`` and ``_bwd`` (the ``jax.custom_vjp``): the last chunk
is padded with zero columns masked to ``-inf``, the gold logit is summed
through an arithmetic mask, and the optional logit softcap's derivative is
``1 - tanh^2``.

``sharded_ce_loss`` is the reference's gather-free loss: the fp32 logits,
the label "gather" as an arithmetic mask, plain autograd. Under a
training mesh it takes the layout the reference pins with its sharding
constraints: the tokens stay on this rank's dp rows, the head's
contraction dim is whole (``w`` is ``[d, V/M]``, FSDP-gathered), and the
logits stay ``[T/dp, V/M]``, never gathered; the row max is a MAX and
``se`` and the gold logit a SUM over the model group
(``layers.vocab_parallel_nll``).

loss = mean( logsumexp(logits) - logits[label] ),
logits = softcap(x @ w) with the model's optional logit softcap.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import runtime_context as ctx
from repro_torch.models.layers import tp_input, tp_size, vocab_parallel_nll

NEG = -1e30


def _chunk_logits(x2: torch.Tensor, w: torch.Tensor, c0: int, chunk: int,
                  softcap: Optional[float]):
    """fp32 logits of vocab columns ``[c0, c0 + chunk)`` (columns past the
    vocab: zero weights, masked to ``-inf``), their ids and validity."""
    v = w.shape[1]
    w_c = w[:, c0:c0 + chunk]
    if w_c.shape[1] < chunk:
        w_c = F.pad(w_c, (0, chunk - w_c.shape[1]))
    logits = torch.matmul(x2.float(), w_c.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    col = c0 + torch.arange(chunk, device=x2.device)
    valid = col < v
    logits = torch.where(valid[None, :], logits,
                         torch.full_like(logits, -torch.inf))
    return logits, w_c, col, valid


class _ChunkedCE(torch.autograd.Function):
    """Mean NLL of ``labels1 [T]`` under ``softcap(x2 [T, d] @ w [d, V])``,
    one vocab chunk at a time."""

    @staticmethod
    def forward(ctx, x2, w, labels1, chunk: int, softcap):
        t = x2.shape[0]
        v = w.shape[1]
        m = torch.full((t,), NEG, dtype=torch.float32, device=x2.device)
        s = torch.zeros((t,), dtype=torch.float32, device=x2.device)
        gold = torch.zeros((t,), dtype=torch.float32, device=x2.device)
        for c0 in range(0, v, chunk):
            logits, _, col, _ = _chunk_logits(x2, w, c0, chunk, softcap)
            m_new = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=1)
            hit = labels1[:, None] == col[None, :]
            gold = gold + torch.where(hit, logits,
                                      torch.zeros_like(logits)).sum(dim=1)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(x2, w, labels1, lse)
        ctx.chunk, ctx.softcap = chunk, softcap
        return (lse - gold).sum() / t

    @staticmethod
    def backward(ctx, g):
        x2, w, labels1, lse = ctx.saved_tensors
        chunk, softcap = ctx.chunk, ctx.softcap
        t, d = x2.shape
        v = w.shape[1]
        coef = (g / t).to(torch.float32)
        dx = torch.zeros((t, d), dtype=torch.float32, device=x2.device)
        dws = []
        for c0 in range(0, v, chunk):
            logits, w_c, col, valid = _chunk_logits(x2, w, c0, chunk,
                                                    softcap)
            p = torch.exp(logits - lse[:, None])
            hit = (labels1[:, None] == col[None, :]).to(torch.float32)
            dlog = (p - hit) * coef
            if softcap is not None:
                th = logits / softcap                    # tanh(z / cap)
                dlog = dlog * (1.0 - th * th)
            dlog = torch.where(valid[None, :], dlog, torch.zeros_like(dlog))
            dws.append(torch.matmul(x2.T.float(), dlog).to(w.dtype))
            dx = dx + torch.matmul(dlog, w_c.float().T)
        dw = torch.cat(dws, dim=1)[:, :v]
        return dx.to(x2.dtype), dw, None, None, None


def chunked_ce_loss(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                    *, chunk: int = 16384,
                    logit_softcap: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL over ``[B, S]``; never materializes ``[T, V]``
    logits. x ``[B, S, d]``; w ``[d, V]`` (``embed.T`` for tied
    embeddings); labels ``[B, S]``."""
    b, s, d = x.shape
    if mask is not None:
        # as the reference: masked losses take the unchunked path
        raise NotImplementedError("chunked CE with loss masks")
    return _ChunkedCE.apply(x.reshape(b * s, d), w,
                            labels.reshape(-1).long(), chunk,
                            logit_softcap)


def sharded_ce_loss(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                    *, logit_softcap: Optional[float] = None,
                    vocab: Optional[int] = None) -> torch.Tensor:
    """Gather-free CE (the reference's ``sharded_ce_loss``): fp32 logits,
    the gold logit through an arithmetic label mask. Under a mesh a ``w``
    holding this rank's slice of the ``vocab`` columns gives the mean
    over this rank's tokens through the vocab-parallel reductions."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    labels1 = labels.reshape(-1).long()
    v = w.shape[1]
    sharded = vocab is not None and v != vocab and tp_size() > 1
    if sharded:
        x2 = tp_input(x2)
    logits = torch.matmul(x2.float(), w.float())
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if sharded:
        return vocab_parallel_nll(logits, labels1,
                                  ctx.current_mesh()).mean()
    m = logits.amax(dim=1)
    se = torch.exp(logits - m[:, None]).sum(dim=1)
    lse = m + torch.log(se)
    hit = labels1[:, None] == torch.arange(v, device=x.device)[None, :]
    gold = torch.where(hit, logits, torch.zeros_like(logits)).sum(dim=1)
    return (lse - gold).mean()
