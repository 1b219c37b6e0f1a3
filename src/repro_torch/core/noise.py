"""MLC ReRAM device-noise simulation (paper §3.4, Fig. 2; counterpart of
``repro.core.noise``).

Read errors of multi-level ReRAM cells are discrete perturbations of the
*stored code*: with probability p_- the read code is one step below the
written one, with p_+ one step above (adjacent-level confusion), otherwise
exact. In weight space the error is e in {-Delta(s), 0, +Delta(s)}.

The draws come from an explicit ``torch.Generator`` on the codes' device.
They cannot equal ``jax.random``'s from any seed, so the two packages
agree on the distribution of the flips, not on the flips themselves.
"""
from __future__ import annotations

import torch

from repro_torch.core.qconfig import NoiseModel
from repro_torch.core.quantizers import qrange


def perturb_codes(gen: torch.Generator, codes: torch.Tensor, bits: int,
                  noise: NoiseModel) -> torch.Tensor:
    """Flip each code by -1/+1 with (p_minus, p_plus); clip to the code
    range. Clipping mirrors the device: the lowest/highest conductance
    states can only be confused inward."""
    qmin, qmax = qrange(bits)
    u = torch.rand(codes.shape, generator=gen, device=codes.device,
                   dtype=torch.float32)
    p_m = noise.p_minus
    delta = torch.where(u < p_m, -1.0,
                        torch.where(u < p_m + noise.p_plus, 1.0, 0.0))
    return torch.clamp(codes + delta.to(codes.dtype), qmin, qmax)


def perturb_weights(gen: torch.Generator, w_deq: torch.Tensor,
                    scale: torch.Tensor, bits: int,
                    noise: NoiseModel) -> torch.Tensor:
    """Apply the code-flip model to dequantized weights W = codes * scale."""
    s = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.round(w_deq / s)
    noisy = perturb_codes(gen, codes, bits, noise)
    return noisy * torch.broadcast_to(scale, w_deq.shape).to(w_deq.dtype)


def confusion_matrix(bits: int, noise: NoiseModel) -> torch.Tensor:
    """Level confusion matrix P(read=j | written=i) for 2**bits states."""
    n = 2 ** bits
    p_m, p_p = noise.p_minus, noise.p_plus
    m = torch.zeros((n, n), dtype=torch.float32)
    idx = torch.arange(n)
    m[idx, idx] = 1.0 - p_m - p_p
    m[idx[1:], idx[1:] - 1] += p_m
    m[idx[:-1], idx[:-1] + 1] += p_p
    # boundary states fold the outward flip back onto themselves (clipping)
    m[0, 0] += p_m
    m[n - 1, n - 1] += p_p
    return m


def ber_from_confusion(bits: int, noise: NoiseModel) -> float:
    """Aggregate raw bit-error-ish rate: P(read != written), uniform
    codes."""
    diag = torch.diagonal(confusion_matrix(bits, noise)).contiguous()
    return float(1.0 - torch.mean(diag))
