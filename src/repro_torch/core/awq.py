"""AWQ baseline (Lin et al., 2024), activation-aware weight quantization
(counterpart of ``repro.core.awq``).

Per-input-channel scales s_c = (mean|X_c|)^alpha (normalized), alpha chosen
on a grid to minimize the layer output error ||X W - X (Q(sW)/s)||^2.
Fake-quant equivalence: W_hat = Q(W * s) / s, so no runtime graph rewrite is
needed for accuracy evaluation. Float64 on the weight's device; ``w`` and
``x`` may be tensors or numpy arrays, and the result has ``w``'s type,
dtype and device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qconfig import AWQConfig
from repro_torch.core.quantizers import qrange


def _rtn(w: torch.Tensor, bits: int) -> torch.Tensor:
    qmin, qmax = qrange(bits)
    scale = torch.clamp_min(w.abs().amax(dim=0, keepdim=True), 1e-8) / qmax
    return torch.clamp(torch.round(w / scale), qmin, qmax) * scale


def _candidate(w64, x_mean, alpha: float, bits: int) -> torch.Tensor:
    s = torch.pow(x_mean, alpha)
    s = s / torch.sqrt(s.max() * s.min() + 1e-12)   # normalize dynamic range
    s = torch.clamp_min(s, 1e-4)
    return _rtn(w64 * s[:, None], bits) / s[:, None]


def awq_quantize(w, x, cfg: AWQConfig = AWQConfig()):
    """Return fake-quantized weights (same shape and dtype as ``w``).

    w: ``[din, dout]``; x: ``[n_samples, din]`` captured calibration
    inputs. Of the grid's errors the first strict minimum wins, as in the
    reference's loop; the errors are read back once."""
    dev = w.device if isinstance(w, torch.Tensor) else torch.device("cpu")
    w64 = torch.as_tensor(w, device=dev).to(torch.float64)
    x64 = torch.as_tensor(x, device=dev).to(torch.float64).reshape(
        -1, w64.shape[0])

    x_mean = x64.abs().mean(dim=0) + 1e-8            # [din]
    y_ref = x64 @ w64
    errs = torch.stack([
        torch.mean((y_ref - x64 @ _candidate(w64, x_mean, g / cfg.n_grid,
                                             cfg.bits)) ** 2)
        for g in range(cfg.n_grid)])
    best, best_err = None, float("inf")
    for g, err in enumerate(errs.cpu().tolist()):
        if err < best_err:
            best, best_err = g, err
    out = _candidate(w64, x_mean, best / cfg.n_grid, cfg.bits)
    if isinstance(w, torch.Tensor):
        return out.to(w.dtype)
    return out.cpu().numpy().astype(np.asarray(w).dtype)
