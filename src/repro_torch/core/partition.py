"""Subtile outlier partitioning (the subtile half of
``repro.core.partition``).

The tensor is tiled into (8, 128) subtiles; the rho fraction of subtiles
with the largest max-|w| become the outlier stream.
"""
from __future__ import annotations

from typing import Tuple

import torch


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
