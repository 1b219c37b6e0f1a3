"""Symmetric per-channel quantizers and the scale searches QMC uses
(counterpart of ``repro.core.quantizers``).

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


def dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(scale.dtype) * scale


def fake_quant(w: torch.Tensor, scale: torch.Tensor,
               bits: int) -> torch.Tensor:
    return dequantize(quantize_codes(w, scale, bits), scale)


def _reduced_axes(ndim: int, channel_axis: int) -> Tuple[int, ...]:
    ch = channel_axis % ndim
    return tuple(a for a in range(ndim) if a != ch)


def minmax_scale(w: torch.Tensor, bits: int, channel_axis: int = -1,
                 eps: float = 1e-8) -> torch.Tensor:
    """Per-channel abs-max scale, broadcastable against ``w``."""
    _, qmax = qrange(bits)
    amax = torch.amax(torch.abs(w), dim=_reduced_axes(w.ndim, channel_axis),
                      keepdim=True)
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


def mse_scale_search(w: torch.Tensor, bits: int, channel_axis: int = -1,
                     grid_lo: float = 0.3, grid_hi: float = 1.05,
                     grid_n: int = 48,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-channel grid search minimizing ||W - Q(W;s)||^2 (Alg. 1,
    Step 3); ``mask`` restricts the objective to a subset of entries."""
    return noise_aware_scale_search(
        w, bits, None, channel_axis=channel_axis, grid_lo=grid_lo,
        grid_hi=grid_hi, grid_n=grid_n, mask=mask)


def noise_aware_scale_search(
        w: torch.Tensor, bits: int, noise: Optional[NoiseModel],
        channel_axis: int = -1, grid_lo: float = 0.3, grid_hi: float = 1.05,
        grid_n: int = 48, mask: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """Per-channel grid search minimizing Eq. (7).

    With ``noise=None`` it is the plain MSE objective (Step 3); otherwise
    the per-channel count of entries times (p- + p+) * s^2 penalizes large
    steps (Step 2). ``mask`` restricts the objective to a subset of
    entries. Ties keep the earlier grid point (strict ``<``)."""
    red = _reduced_axes(w.ndim, channel_axis)
    base = minmax_scale(w, bits, channel_axis=channel_axis)
    if mask is None:
        n_per_ch = torch.tensor(float(w.numel()) / w.shape[channel_axis],
                                device=w.device)
        maskf = None
    else:
        maskf = mask.to(w.dtype)
        n_per_ch = torch.sum(maskf, dim=red, keepdim=True)
    p_flip = 0.0 if noise is None else float(noise.p_flip)
    alphas = scale_grid(grid_lo, grid_hi, grid_n, device=w.device)
    best_loss = torch.full_like(base, float("inf"))
    best_alpha = torch.ones_like(base)
    for i in range(grid_n):
        s = base * alphas[i]
        err = w - fake_quant(w, s, bits)
        if maskf is not None:
            err = err * maskf
        loss = (torch.sum(torch.square(err), dim=red, keepdim=True)
                + n_per_ch * p_flip * torch.square(s))
        take = loss < best_loss
        best_loss = torch.where(take, loss, best_loss)
        best_alpha = torch.where(take, alphas[i], best_alpha)
    return base * best_alpha


def rtn_quantize(w: torch.Tensor, bits: int = 4, channel_axis: int = -1
                 ) -> torch.Tensor:
    """Rounding-to-nearest baseline: per-channel abs-max scale,
    fake-quant."""
    s = minmax_scale(w, bits, channel_axis=channel_axis)
    return fake_quant(w, s, bits)


def expected_noise_mse(w: torch.Tensor, scale: torch.Tensor, bits: int,
                       noise: NoiseModel) -> torch.Tensor:
    """Closed-form E_e ||W - (Q(W;s)+e)||^2 under the +-1-step flip
    model."""
    dist = torch.sum(torch.square(w - fake_quant(w, scale, bits)))
    step2 = torch.sum(torch.broadcast_to(torch.square(scale), w.shape)) \
        * noise.p_flip
    return dist + step2
