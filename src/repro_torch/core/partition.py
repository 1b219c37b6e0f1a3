"""Outlier/inlier weight partitioning (paper Eq. 1; counterpart of
``repro.core.partition``).

Two granularities:

* scalar  — tau is the (1-rho) quantile of |W| per tensor; W_out = {w :
            |w| > tau} (Algorithm 1, Step 1);
* subtile — the tensor is tiled into (8, 128) subtiles; the rho fraction
            of subtiles with the largest max-|w| become the outlier stream.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of all of ``x`` by ``jnp.quantile``'s "linear"
    rule, in its float32 arithmetic: position ``q * (n - 1)``, the sorted
    values at its floor and ceil weighted by the fraction. Written out
    because ``torch.quantile`` refuses inputs above 2^24 elements, and a
    full-width ``lm_head`` has 2048 x 100352."""
    flat = torch.sort(x.reshape(-1).to(torch.float32)).values
    f32 = dict(dtype=torch.float32, device=x.device)
    n = torch.tensor(float(flat.numel()), **f32)
    pos = torch.tensor(q, **f32) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    lo_i = int(torch.clamp(low, torch.zeros_like(n), n - 1).item())
    hi_i = int(torch.clamp(high, torch.zeros_like(n), n - 1).item())
    return flat[lo_i] * lw + flat[hi_i] * hw


def scalar_outlier_mask(w: torch.Tensor, rho: float) -> torch.Tensor:
    """Boolean mask of the top-rho fraction of |w| (per tensor)."""
    if rho <= 0.0:
        return torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    if rho >= 1.0:
        return torch.ones(w.shape, dtype=torch.bool, device=w.device)
    tau = quantile_linear(torch.abs(w), 1.0 - rho)
    return torch.abs(w) > tau


def _subtile_grid(shape, subtile: Tuple[int, int]) -> Tuple[int, int]:
    r, c = subtile
    if shape[0] % r or shape[1] % c:
        raise ValueError(f"shape {tuple(shape)} not divisible by subtile "
                         f"{subtile}")
    return shape[0] // r, shape[1] // c


def subtile_scores(w: torch.Tensor, subtile: Tuple[int, int] = (8, 128)
                   ) -> torch.Tensor:
    """max |w| per subtile -> [gr, gc]."""
    gr, gc = _subtile_grid(w.shape, subtile)
    r, c = subtile
    return torch.abs(w.reshape(gr, r, gc, c)).amax(dim=(1, 3))


def subtile_outlier_mask(w: torch.Tensor, rho: float,
                         subtile: Tuple[int, int] = (8, 128)
                         ) -> torch.Tensor:
    """[gr, gc] bool mask with exactly round(rho * n_sub) outlier
    subtiles; ties at the threshold keep the first positions in row-major
    order."""
    scores = subtile_scores(w, subtile)
    n_sub = scores.numel()
    k = int(round(rho * n_sub))
    if k <= 0:
        return torch.zeros(scores.shape, dtype=torch.bool, device=w.device)
    if k >= n_sub:
        return torch.ones(scores.shape, dtype=torch.bool, device=w.device)
    flat = scores.reshape(-1)
    thresh = torch.sort(flat).values[n_sub - k]        # k-th largest
    mask = flat >= thresh
    cum = torch.cumsum(mask.to(torch.int32), dim=0)
    return (mask & (cum <= k)).reshape(scores.shape)


def expand_subtile_mask(mask: torch.Tensor, shape,
                        subtile: Tuple[int, int] = (8, 128)) -> torch.Tensor:
    """Broadcast a [gr, gc] subtile mask to elementwise shape."""
    r, c = subtile
    gr, gc = mask.shape
    assert (gr * r, gc * c) == tuple(shape)
    return mask.repeat_interleave(r, dim=0).repeat_interleave(c, dim=1)


def partition(w: torch.Tensor, rho: float, granularity: str = "scalar",
              subtile: Tuple[int, int] = (8, 128)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_in, w_out) with zeros at the other set's positions, so that
    w == w_in + w_out exactly (the scatter/merge identity of Algorithm 1,
    Step 4)."""
    if granularity == "scalar":
        m = scalar_outlier_mask(w, rho)
    elif granularity == "subtile":
        m = expand_subtile_mask(subtile_outlier_mask(w, rho, subtile),
                                w.shape, subtile)
    else:
        raise ValueError(f"unknown granularity: {granularity}")
    zero = torch.zeros_like(w)
    return torch.where(m, zero, w), torch.where(m, w, zero)
