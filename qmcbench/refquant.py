"""The reference's own copy of QMC's serving format (Algorithm 1 at
subtile granularity), from the dense weights to the dense fp32 matrix the
format stands for. It follows the paper's steps in plain torch and takes
nothing from the program:

1. tile W [din, dout] into (8, 128) subtiles; the round(rho * n) subtiles
   with the largest max|w| are outliers (ties keep the first in row-major
   order), the rest inliers;
2. per output column, the inlier scale minimises the squared error over
   the inliers plus n_inliers * (p- + p+) * s^2 (3-bit MLC cells flip a
   code by one step with p- = p+ = 0.015), the outlier scale the squared
   error over the outliers; both over alpha * absmax / qmax for alpha on
   48 points from 0.3 to 1.05, the first minimum kept;
3. codes are round-half-to-even of w / s clipped to [-4, 3] (3 bits) or
   [-16, 15] (5 bits), and each weight is its code times its stream's
   column scale.

Which leaves are quantized is the serving conversion's rule: 2-D to 4-D
float leaves whose path names no embedding, norm, scale, bias or SSM
constant, whose last two dims are at least ``min_dim``, and whose
``[din, dout]`` tiles by the subtile; stacked leaves per group."""
from __future__ import annotations

import torch

EXCLUDE = ("embed", "norm", "scale", "bias", "a_log", "dt_bias", "conv",
           "d_skip", "pos")


def quantized_shape(path: str, shape, q: dict) -> bool:
    """Whether the float leaf at ``path`` of ``shape`` is quantized."""
    r, c = q["subtile"]
    if len(shape) < 2 or len(shape) > 4:
        return False
    if any(s in path.lower() for s in EXCLUDE):
        return False
    din, dout = shape[-2:]
    return (min(din, dout) >= q["min_dim"] and din % r == 0
            and dout % c == 0)


def _grid(q: dict, device) -> torch.Tensor:
    lo, hi, n = q["scale_grid"]
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=device)
    return torch.cat([lo_t * (1 - t) + hi_t * t, hi_t.reshape(1)])


def _codes(w, s, bits):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.clamp(torch.round(w / s), lo, hi)


def _scale(w, mask, bits, p_flip, alphas):
    """Per-column scale [1, dout] minimising the masked error (+ the noise
    term), the first of equal minima kept."""
    hi = 2 ** (bits - 1) - 1
    base = torch.clamp_min(torch.amax(torch.abs(w), dim=0, keepdim=True),
                           1e-8) / float(hi)
    maskf = mask.to(w.dtype)
    n = torch.sum(maskf, dim=0, keepdim=True)
    best = torch.full_like(base, float("inf"))
    alpha = torch.ones_like(base)
    for i in range(alphas.numel()):
        s = base * alphas[i]
        err = (w - _codes(w, s, bits) * s) * maskf
        loss = (torch.sum(torch.square(err), dim=0, keepdim=True)
                + n * p_flip * torch.square(s))
        take = loss < best
        best = torch.where(take, loss, best)
        alpha = torch.where(take, alphas[i], alpha)
    return base * alpha


def qmc_matrix(w: torch.Tensor, q: dict) -> torch.Tensor:
    """The dense fp32 matrix that QMC's format stores for ``w [din,
    dout]``."""
    w = w.to(torch.float32)
    r, c = q["subtile"]
    din, dout = w.shape
    gr, gc = din // r, dout // c
    score = torch.abs(w.reshape(gr, r, gc, c)).amax(dim=(1, 3)).reshape(-1)
    n_sub = score.numel()
    k = int(round(q["rho"] * n_sub))
    if k <= 0:
        sub = torch.zeros(n_sub, dtype=torch.bool, device=w.device)
    elif k >= n_sub:
        sub = torch.ones(n_sub, dtype=torch.bool, device=w.device)
    else:
        thresh = torch.sort(score).values[n_sub - k]
        sub = score >= thresh
        sub = sub & (torch.cumsum(sub.to(torch.int32), dim=0) <= k)
    out = (sub.reshape(gr, gc).repeat_interleave(r, dim=0)
           .repeat_interleave(c, dim=1))
    alphas = _grid(q, w.device)
    p_flip = 0.03 if q["cell_bits"] == 3 else 0.004
    s_in = _scale(w, ~out, q["bits_in"], p_flip, alphas)
    s_out = _scale(w, out, q["bits_out"], 0.0, alphas)

    def deq(s, bits):
        return _codes(w, s, bits) * s
    return torch.where(out, deq(s_out, q["bits_out"]),
                       deq(s_in, q["bits_in"]))


def format_params(tree: dict, q: dict, prefix: str = "") -> dict:
    """``tree`` with every leaf the format quantizes replaced, in place of
    the dense one, by the matrix the format stores (per group of a
    stacked leaf). Leaves are replaced one at a time, so that at most one
    dense leaf is held twice."""
    for key, v in list(tree.items()):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(v, dict):
            format_params(v, q, path)
        elif v.is_floating_point() and quantized_shape(path, v.shape, q):
            flat = v.reshape((-1,) + tuple(v.shape[-2:]))
            for i in range(flat.shape[0]):
                flat[i] = qmc_matrix(flat[i], q)
    return tree
