"""Symmetric per-channel quantizers and the scale searches QMC uses (the
parts of ``repro.core.quantizers`` that ``quantize_qtensor`` calls).

The noise-aware scale search implements Eq. (5)-(7) of the paper: the
expected distortion of storing Q(W; s) in a noisy MLC memory is

    L(s) ~= ||W - Q(W; s)||^2 + N * (p_- + p_+) * Delta(s)^2

with Delta(s) = s for a uniform quantizer, minimized per channel over a
grid of candidate scales.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.qconfig import NoiseModel


def qrange(bits: int) -> Tuple[int, int]:
    """Symmetric signed range for `bits` (e.g. 3 -> [-4, 3])."""
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def quantize_codes(w: torch.Tensor, scale: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """Round-half-to-even codes, clipped to the signed range (float
    carrier). ``torch.round`` rounds half to even, as ``jnp.round``."""
    qmin, qmax = qrange(bits)
    s = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(w / s), qmin, qmax)


def fake_quant(w: torch.Tensor, scale: torch.Tensor,
               bits: int) -> torch.Tensor:
    return quantize_codes(w, scale, bits).to(scale.dtype) * scale


def minmax_scale(w: torch.Tensor, bits: int, eps: float = 1e-8
                 ) -> torch.Tensor:
    """Per-output-channel abs-max scale of a 2-D ``w`` -> [1, dout]."""
    _, qmax = qrange(bits)
    amax = torch.amax(torch.abs(w), dim=0, keepdim=True)
    return torch.clamp_min(amax, eps) / float(qmax)


def scale_grid(lo: float, hi: float, n: int,
               device=None) -> torch.Tensor:
    """The alpha grid, by ``jnp.linspace``'s formula (start * (1 - t) +
    stop * t). The two libraries may still round a grid point
    differently in its last bit."""
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=device)
    return torch.cat([lo_t * (1 - t) + hi_t * t, hi_t.reshape(1)])


def noise_aware_scale_search(
        w: torch.Tensor, bits: int, noise: Optional[NoiseModel],
        grid_lo: float = 0.3, grid_hi: float = 1.05, grid_n: int = 48,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-output-channel grid search minimizing Eq. (7) for 2-D ``w``.

    With ``noise=None`` it is the plain MSE objective (Step 3); otherwise
    the per-channel count of entries times (p- + p+) * s^2 penalizes large
    steps (Step 2). ``mask`` restricts the objective to a subset of
    entries. Ties keep the earlier grid point (strict ``<``)."""
    base = minmax_scale(w, bits)
    if mask is None:
        n_per_ch = torch.tensor(float(w.numel()) / w.shape[1],
                                device=w.device)
        maskf = None
    else:
        maskf = mask.to(w.dtype)
        n_per_ch = torch.sum(maskf, dim=0, keepdim=True)
    p_flip = 0.0 if noise is None else float(noise.p_flip)
    alphas = scale_grid(grid_lo, grid_hi, grid_n, device=w.device)
    best_loss = torch.full_like(base, float("inf"))
    best_alpha = torch.ones_like(base)
    for i in range(grid_n):
        s = base * alphas[i]
        err = w - fake_quant(w, s, bits)
        if maskf is not None:
            err = err * maskf
        loss = (torch.sum(torch.square(err), dim=0, keepdim=True)
                + n_per_ch * p_flip * torch.square(s))
        take = loss < best_loss
        best_loss = torch.where(take, loss, best_loss)
        best_alpha = torch.where(take, alphas[i], best_alpha)
    return base * best_alpha


def mse_scale_search(w: torch.Tensor, bits: int, grid_lo: float = 0.3,
                     grid_hi: float = 1.05, grid_n: int = 48,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-channel grid search minimizing ||W - Q(W;s)||^2 (Alg. 1,
    Step 3)."""
    return noise_aware_scale_search(w, bits, None, grid_lo, grid_hi,
                                    grid_n, mask)
