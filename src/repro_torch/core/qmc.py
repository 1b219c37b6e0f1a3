"""Algorithm 1 — Outlier-Aware Robust Quantization (counterpart of
``repro.core.qmc``).

`qmc_quantize` is the paper-faithful scalar-granularity routine:

  Step 1  partition W into outliers (top-rho by |w|) and inliers,
  Step 2  inlier scale via noise-aware search (Eq. 5-7), quantize to 3 bits,
  Step 3  outlier scale via plain MSE search, quantize to 5 bits,
  Step 4  scatter/merge: W~ = scatter(W_in*, W_out*).

It returns the fake-quantized tensor plus the pieces the memory simulator
and the noise-injection studies need.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import partition as part
from repro_torch.core.noise import perturb_codes
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.quantizers import (dequantize, mse_scale_search,
                                         noise_aware_scale_search,
                                         quantize_codes)


@dataclasses.dataclass
class QMCResult:
    w_hat: torch.Tensor          # merged fake-quantized weights (Step 4)
    outlier_mask: torch.Tensor   # elementwise bool (True -> MRAM/outlier)
    scale_in: torch.Tensor       # per-channel inlier scale
    scale_out: torch.Tensor      # per-channel outlier scale
    codes_in: torch.Tensor       # inlier codes (zeros at outlier slots)
    codes_out: torch.Tensor      # outlier codes (zeros at inlier slots)


def _elementwise_mask(w: torch.Tensor, cfg: QMCConfig) -> torch.Tensor:
    if cfg.granularity == "subtile" and w.ndim == 2 \
            and w.shape[0] % cfg.subtile[0] == 0 \
            and w.shape[1] % cfg.subtile[1] == 0:
        sub = part.subtile_outlier_mask(w, cfg.rho, cfg.subtile)
        return part.expand_subtile_mask(sub, w.shape, cfg.subtile)
    if cfg.granularity in ("scalar", "subtile"):
        # subtile granularity degrades to scalar on non-tileable shapes
        return part.scalar_outlier_mask(w, cfg.rho)
    raise ValueError(cfg.granularity)


def qmc_quantize(w: torch.Tensor, cfg: QMCConfig,
                 noise_aware: bool = True) -> QMCResult:
    """Run Algorithm 1 on one weight tensor (any >= 1-D tensor; the
    per-channel axis is ``cfg.channel_axis``)."""
    w = w.to(torch.float32)
    mask = _elementwise_mask(w, cfg)
    noise = cfg.noise if noise_aware else None
    grid = dict(channel_axis=cfg.channel_axis, grid_lo=cfg.scale_grid_lo,
                grid_hi=cfg.scale_grid_hi, grid_n=cfg.scale_grid_n)
    scale_in = noise_aware_scale_search(w, cfg.bits_in, noise, mask=~mask,
                                        **grid)
    scale_out = mse_scale_search(w, cfg.bits_out, mask=mask, **grid)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    codes_in = torch.where(mask, zero,
                           quantize_codes(w, scale_in, cfg.bits_in))
    codes_out = torch.where(mask, quantize_codes(w, scale_out, cfg.bits_out),
                            zero)
    w_hat = torch.where(mask, dequantize(codes_out, scale_out),
                        dequantize(codes_in, scale_in))
    return QMCResult(w_hat=w_hat, outlier_mask=mask, scale_in=scale_in,
                     scale_out=scale_out, codes_in=codes_in,
                     codes_out=codes_out)


def apply_reram_noise(gen: torch.Generator, res: QMCResult,
                      cfg: QMCConfig) -> torch.Tensor:
    """Simulate deployment: inlier codes sit in noisy MLC ReRAM, outliers
    in (noise-free) MRAM. Returns the noisy merged weights."""
    noisy_in = perturb_codes(gen, res.codes_in, cfg.bits_in, cfg.noise)
    w_in = dequantize(noisy_in, res.scale_in)
    w_out = dequantize(res.codes_out, res.scale_out)
    return torch.where(res.outlier_mask, w_out, w_in)


def qmc_fake_quant(w: torch.Tensor, cfg: QMCConfig,
                   noise_gen: Optional[torch.Generator] = None,
                   noise_aware: bool = True) -> torch.Tensor:
    """One-call fake-quant: Algorithm 1, then simulated ReRAM read noise
    drawn from ``noise_gen`` when one is given."""
    res = qmc_quantize(w, cfg, noise_aware=noise_aware)
    if noise_gen is None:
        return res.w_hat.to(w.dtype)
    return apply_reram_noise(noise_gen, res, cfg).to(w.dtype)


def quantization_mse(w: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(w.to(torch.float32)
                                   - w_hat.to(torch.float32)))
