"""GPTQ baseline (Frantar et al., 2022), calibration-based PTQ (counterpart
of ``repro.core.gptq``).

Hessian-guided column-wise rounding with block error propagation, via the
Cholesky-of-inverse formulation. Runs eagerly in float64 on the weight's
device (the card when the model lies there): this is an offline procedure,
and stability comes before speed.

Weights use the ``[din, dout]`` convention; per-output-channel symmetric
scales. Calibration inputs X are the captured layer inputs ``[n_samples,
din]``. ``w`` and ``x`` may be tensors or numpy arrays; the result has
``w``'s type, dtype and device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qconfig import GPTQConfig
from repro_torch.core.quantizers import qrange


def _as_f64(a, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device).to(torch.float64)


def gptq_quantize(w, x, cfg: GPTQConfig = GPTQConfig()):
    """Return fake-quantized weights (same shape and dtype as ``w``)."""
    dev = w.device if isinstance(w, torch.Tensor) else torch.device("cpu")
    w64 = _as_f64(w, dev)                           # [din, dout]
    din, dout = w64.shape
    x64 = _as_f64(x, dev).reshape(-1, din)
    qmin, qmax = qrange(cfg.bits)

    # Hessian of the layerwise objective ||XW - XW_q||^2
    h = 2.0 * (x64.T @ x64)
    diag = torch.arange(din, device=dev)
    dead = torch.nonzero(torch.diagonal(h) == 0).squeeze(1)
    h[dead, dead] = 1.0
    w_work = w64.T.clone()                          # [dout, din] rows=out ch
    w_work[:, dead] = 0.0

    damp = cfg.percdamp * torch.diagonal(h).mean()
    h[diag, diag] += damp

    # Cholesky of the inverse Hessian (upper-triangular), GPTQ's trick
    hinv = torch.linalg.inv(h)
    hinv = torch.linalg.cholesky((hinv + hinv.T) / 2.0).T  # upper

    # per-output-channel abs-max scales from the *original* weights
    scale = torch.clamp_min(w_work.abs().amax(dim=1), 1e-8) / qmax

    q_out = torch.zeros_like(w_work)
    bs = cfg.block_size
    for b0 in range(0, din, bs):
        b1 = min(b0 + bs, din)
        w_blk = w_work[:, b0:b1].clone()
        err_blk = torch.zeros_like(w_blk)
        for j in range(b1 - b0):
            col = w_blk[:, j]
            q = torch.clamp(torch.round(col / scale), qmin, qmax)
            dq = q * scale
            q_out[:, b0 + j] = dq
            err = (col - dq) / hinv[b0 + j, b0 + j]
            # propagate within the block
            if j + 1 < b1 - b0:
                w_blk[:, j + 1:] -= torch.outer(
                    err, hinv[b0 + j, b0 + j + 1:b1])
            err_blk[:, j] = err
        # propagate to the remaining columns
        if b1 < din:
            w_work[:, b1:] -= err_blk @ hinv[b0:b1, b1:]

    out = q_out.T
    if isinstance(w, torch.Tensor):
        return out.to(w.dtype)
    return out.cpu().numpy().astype(np.asarray(w).dtype)
