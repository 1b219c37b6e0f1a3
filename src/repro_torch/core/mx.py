"""MXINT4 microscaling baseline (Sharify et al., arXiv:2405.07135;
counterpart of ``repro.core.mx``).

Blocks of `block` consecutive elements along the input-channel axis share
an 8-bit power-of-two scale (E8M0); elements are signed INT4. This is the
"hybrid data format" the paper compares against in Table 2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.qconfig import MXConfig
from repro_torch.core.quantizers import qrange


def mx_fake_quant(w: torch.Tensor, cfg: MXConfig = MXConfig()
                  ) -> torch.Tensor:
    orig_dtype = w.dtype
    w = w.to(torch.float32)
    axis = cfg.block_axis % w.ndim
    length = w.shape[axis]
    if length % cfg.block:
        # pad to a whole number of blocks, quantize, then crop
        pad = [0, 0] * w.ndim
        pad[2 * (w.ndim - 1 - axis) + 1] = cfg.block - length % cfg.block
        wq = mx_fake_quant(F.pad(w, pad), cfg)
        return wq.narrow(axis, 0, length).to(orig_dtype)

    w_moved = torch.movedim(w, axis, 0)
    lead = w_moved.shape[0]
    blocked = w_moved.reshape(lead // cfg.block, cfg.block,
                              *w_moved.shape[1:])
    qmin, qmax = qrange(cfg.bits)
    amax = torch.amax(torch.abs(blocked), dim=1, keepdim=True)
    # E8M0 shared exponent: the power of two with amax / scale <= qmax
    exp = torch.ceil(torch.log2(torch.clamp_min(amax, 1e-30) / qmax))
    scale = torch.exp2(exp)
    q = torch.clamp(torch.round(blocked / scale), qmin, qmax)
    deq = (q * scale).reshape(w_moved.shape)
    return torch.movedim(deq, 0, axis).to(orig_dtype)
