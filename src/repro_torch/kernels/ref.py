"""Plain PyTorch versions of every kernel in this package.

Each has its kernel's signature. The CPU tests run them (a kernel wrapper
given a CPU tensor takes them), and ``chip_smoke.py`` holds each kernel
against them on the card — with ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` off, so they run in full fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.packing import unpack_codes
from repro_torch.core.qtensor import QTensor, dequantize_qtensor


def qmm_ref(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Dual-stream quantized matmul: x [M, K] @ dequant(qt) [K, N], fp32
    accumulation, result in x's dtype."""
    w = dequantize_qtensor(qt, dtype=torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


def unpack3b_ref(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Decode a little-endian 3-bit stream (packed uint8) to int32 codes,
    minus the bias 4: ``core.packing.unpack_codes`` for bits=3."""
    return unpack_codes(packed, 3, n)


def ragged_paged_attention_ref(
        q: torch.Tensor, cache: dict, q_start: torch.Tensor,
        kv_len: torch.Tensor, *, n_kv: int, head_dim: int,
        window: Optional[int] = None, attn_softcap: Optional[float] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ragged attention by full-width gather (every block-table slot of
    every lane) and masked softmax. Returns ``(o [B, S, H, hd], m, l
    [B, S, H])`` in fp32: the softmax max and sum of every row; rows at
    positions ``>= kv_len`` give exactly 0 (``m = -1e30``, ``l = 0``)."""
    from repro_torch.models.attention import paged_cache_read
    b, s, h, hd = q.shape
    g = h // n_kv
    k, v = paged_cache_read(cache, torch.float32, n_kv, hd)   # [B,T,KV,hd]
    t = k.shape[1]
    qg = q.to(torch.float32).reshape(b, s, n_kv, g, hd) * float(hd) ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
    if attn_softcap:
        scores = attn_softcap * torch.tanh(scores / attn_softcap)
    q_start = q_start.to(torch.int64)
    kv_len = kv_len.to(torch.int64)
    pos_q = (q_start[:, None] + torch.arange(s, device=q.device)[None, :]
             )[:, None, None, :, None]                      # [B,1,1,S,1]
    pos_k = torch.arange(t, device=q.device)[None, None, None, None, :]
    kl = kv_len[:, None, None, None, None]
    mask = (pos_k <= pos_q) & (pos_k < kl) & (pos_q < kl)
    if window is not None:
        mask = mask & (pos_q - pos_k < window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    m = scores.amax(dim=-1)                                  # [B,KV,G,S]
    p = torch.where(mask, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    l = p.sum(dim=-1)
    out = torch.einsum("bkgst,btkd->bkgsd", p, v)
    out = out / torch.clamp_min(l, 1e-30)[..., None]
    o = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return (o, m.permute(0, 3, 1, 2).reshape(b, s, h),
            l.permute(0, 3, 1, 2).reshape(b, s, h))
