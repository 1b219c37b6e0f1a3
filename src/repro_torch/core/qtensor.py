"""QTensor — the QMC dual-stream weight format, as torch tensors.

A weight matrix W[din, dout] is tiled into (8, 128) subtiles. The rho
fraction of subtiles with the largest max-|w| form the *outlier stream*
(5-bit codes in an int8 container); the rest form the *inlier stream*
(3-bit codes, one per int8 byte here — packing two per byte is later work;
the scale is chosen noise-aware). A per-subtile tag + stream position
index reconstructs the dense tile. Counterpart of ``repro.core.qtensor``;
PTQ runs on whatever device ``w`` lies on (the card, in ``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import partition as part
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.quantizers import (mse_scale_search,
                                         noise_aware_scale_search,
                                         quantize_codes)


@dataclasses.dataclass
class QTensor:
    in_codes: torch.Tensor     # [n_in, 8, 128] int8 (3-bit codes)
    out_codes: torch.Tensor    # [n_out, 8, 128] int8 (5-bit codes)
    stream_pos: torch.Tensor   # [gr, gc] int32: index into own stream
    is_out: torch.Tensor       # [gr, gc] bool tag
    scale_in: torch.Tensor     # [1, dout] f32 per-output-channel scale
    scale_out: torch.Tensor    # [1, dout] f32
    shape: Tuple[int, int]
    bits_in: int
    bits_out: int
    subtile: Tuple[int, int]

    @property
    def device(self) -> torch.device:
        return self.scale_in.device

    def to(self, device) -> "QTensor":
        return dataclasses.replace(
            self, in_codes=self.in_codes.to(device),
            out_codes=self.out_codes.to(device),
            stream_pos=self.stream_pos.to(device),
            is_out=self.is_out.to(device),
            scale_in=self.scale_in.to(device),
            scale_out=self.scale_out.to(device))


def quantize_qtensor(w: torch.Tensor, cfg: QMCConfig) -> QTensor:
    """Build the dual-stream format from a dense 2-D weight (PTQ-time)."""
    if w.ndim != 2:
        raise ValueError("QTensor holds 2-D weights")
    w = w.to(torch.float32)
    r, c = cfg.subtile
    din, dout = w.shape
    gr, gc = din // r, dout // c
    n_sub = gr * gc

    sub_mask = part.subtile_outlier_mask(w, cfg.rho, cfg.subtile)
    elem_mask = part.expand_subtile_mask(sub_mask, w.shape, cfg.subtile)
    scale_in = noise_aware_scale_search(
        w, cfg.bits_in, cfg.noise, grid_lo=cfg.scale_grid_lo,
        grid_hi=cfg.scale_grid_hi, grid_n=cfg.scale_grid_n, mask=~elem_mask)
    scale_out = mse_scale_search(
        w, cfg.bits_out, grid_lo=cfg.scale_grid_lo,
        grid_hi=cfg.scale_grid_hi, grid_n=cfg.scale_grid_n, mask=elem_mask)
    codes_in = quantize_codes(w, scale_in, cfg.bits_in)
    codes_out = quantize_codes(w, scale_out, cfg.bits_out)

    # compact streams in grid scan order (sizes are data-dependent: the
    # stream layout is built on the host)
    flat_mask = sub_mask.reshape(-1).cpu().numpy()
    k_out = int(flat_mask.sum())
    k_in = n_sub - k_out
    order = np.arange(n_sub)
    in_ids = torch.as_tensor(order[~flat_mask], device=w.device)
    out_ids = torch.as_tensor(order[flat_mask], device=w.device)

    def tiles_of(x):
        return (x.reshape(gr, r, gc, c).permute(0, 2, 1, 3)
                .reshape(n_sub, r, c))

    t_in = tiles_of(codes_in)[in_ids].to(torch.int8)
    t_out = tiles_of(codes_out)[out_ids].to(torch.int8)
    pos = np.zeros(n_sub, np.int32)
    pos[order[~flat_mask]] = np.arange(k_in, dtype=np.int32)
    pos[order[flat_mask]] = np.arange(k_out, dtype=np.int32)
    # non-empty streams, as the JAX format guarantees
    if k_in == 0:
        t_in = torch.zeros((1, r, c), dtype=torch.int8, device=w.device)
    if k_out == 0:
        t_out = torch.zeros((1, r, c), dtype=torch.int8, device=w.device)
    return QTensor(
        in_codes=t_in.contiguous(), out_codes=t_out.contiguous(),
        stream_pos=torch.as_tensor(pos.reshape(gr, gc), device=w.device),
        is_out=sub_mask.contiguous(),
        scale_in=scale_in.to(torch.float32).contiguous(),
        scale_out=scale_out.to(torch.float32).contiguous(),
        shape=(din, dout), bits_in=cfg.bits_in, bits_out=cfg.bits_out,
        subtile=(r, c))


def dequantize_qtensor(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Reassemble the dense weight matrix (the plain version the qmm
    kernels are held against)."""
    r, c = qt.subtile
    gr, gc = qt.is_out.shape
    din, dout = qt.shape
    pos = qt.stream_pos.reshape(-1).long()
    tags = qt.is_out.reshape(-1)
    zero = torch.zeros_like(pos)
    take_in = qt.in_codes[torch.where(tags, zero, pos)]
    take_out = qt.out_codes[torch.where(tags, pos, zero)]
    tiles = torch.where(tags[:, None, None], take_out.to(torch.float32),
                        take_in.to(torch.float32))
    dense = (tiles.reshape(gr, gc, r, c).permute(0, 2, 1, 3)
             .reshape(din, dout))
    emask = part.expand_subtile_mask(qt.is_out, (din, dout), qt.subtile)
    scale = torch.where(emask, qt.scale_out, qt.scale_in)
    return (dense * scale).to(dtype)
