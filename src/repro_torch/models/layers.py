"""Primitive layers: norms, linears (dense or QTensor), rotary embeddings
(counterpart of ``repro.models.layers``).

``matmul_any`` is the one dispatch point where QMC stream weights enter
the forward pass: a :class:`QTensor` goes through ``kernels.ops.qmm`` (the
qmm kernels on the card), a dense tensor through ``torch.matmul``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import ops as kops


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(dt)


def matmul_any(x: torch.Tensor, w, use_kernels: bool = True
               ) -> torch.Tensor:
    """x @ w where w is dense or a QTensor (QMC serving)."""
    if isinstance(w, QTensor):
        return kops.qmm(x, w, use_kernels=use_kernels)
    return torch.matmul(x, w.to(x.dtype))


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
           use_kernels: bool = True) -> torch.Tensor:
    y = matmul_any(x, w, use_kernels=use_kernels)
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
                 scale: bool = False) -> torch.Tensor:
    x = table[tokens]
    if scale:
        x = x * torch.full((), table.shape[1] ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


_ACTS = {"silu": F.silu,
         "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu
         "relu": F.relu}


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in fp32 (``repro.models.layers.cross_entropy_loss``):
    logits ``[B, S, V]``, labels ``[B, S]`` integer; with ``mask`` the
    masked mean, its denominator at least 1."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long()).squeeze(-1)
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def glu_mlp(x: torch.Tensor, p: dict, act: str = "silu", gated: bool = True,
            use_kernels: bool = True, tap=None) -> torch.Tensor:
    actf = _ACTS[act]
    if tap:
        tap("w_up", x)
    if gated:
        h = actf(linear(x, p["w_gate"], use_kernels=use_kernels)) \
            * linear(x, p["w_up"], use_kernels=use_kernels)
    else:
        h = actf(linear(x, p["w_up"], use_kernels=use_kernels))
    if tap:
        tap("w_down", h)
    return linear(h, p["w_down"], use_kernels=use_kernels)
