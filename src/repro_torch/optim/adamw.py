"""AdamW with a configurable moment dtype (counterpart of
``repro.optim.adamw``): the reference's own update, not ``torch.optim``.

Moments default to fp32 (bf16 for the giant models' state). No master
copy: params are the canonical values (bf16 or fp32 per model dtype); the
update math runs in fp32, with the reference's arithmetic step for step
(clip by ``grad_clip / (gnorm + 1e-9)``, bias correction, decay on
``ndim >= 2`` leaves only). State tensors lie on the parameters' device.

On a training mesh every tree is this rank's slices: ``update`` stays
elementwise on them (weight decay keys on ``ndim``, which a slice keeps;
bf16 moments round as they do whole), and ``global_norm(tree, mesh,
owned)`` sums the squares of the slices this rank owns (the step marks
them: a replicated leaf counts on one rank) and SUMs them over every
rank of the grid.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # "bfloat16" for the giant models


class OptState(NamedTuple):
    step: torch.Tensor                 # int32 scalar
    m: Any
    v: Any


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init(params, cfg: AdamWConfig) -> OptState:
    dt = _dtype(cfg.moment_dtype)
    dev = T.leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=T.map_(zeros, params), v=T.map_(zeros, params))


def global_norm(tree, mesh=None, owned=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree``; with a mesh, of the whole
    tree its ranks' slices make up, equal on every rank: this rank adds
    the leaves ``owned`` marks (one bool per leaf in ``tree.leaves``
    order; each leaf's blocks are owned once over the grid) and the sum
    is taken over every rank."""
    leaves = T.leaves(tree)
    if owned is None:
        owned = [True] * len(leaves)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for keep, leaf in zip(owned, leaves):
        if keep:
            total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    if mesh is not None:
        total = mesh.all_reduce(total, "all", kind="norm")
    return torch.sqrt(total)


def update(grads, state: OptState, params, cfg: AdamWConfig,
           lr_scale=1.0, gnorm=None) -> Tuple[Any, OptState, dict]:
    """One step: ``(new params, new state, {"grad_norm"})``; ``gnorm``
    (the mesh's ``global_norm``) in place of the tree's own."""
    step = state.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            if cfg.grad_clip else 1.0)
    dt = _dtype(cfg.moment_dtype)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(torch.full((), b1, device=step.device),
                         step.to(torch.float32))
    c2 = 1.0 - torch.pow(torch.full((), b2, device=step.device),
                         step.to(torch.float32))
    lr = cfg.lr * lr_scale

    def upd(g, m, v, p):
        g = g.to(torch.float32) * clip
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
        mh, vh = m32 / c1, v32 / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if p.ndim >= 2:  # decay matrices only (norms/bias exempt)
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return ((p.to(torch.float32) - lr * delta).to(p.dtype),
                m32.to(dt), v32.to(dt))

    out = [upd(*a) for a in zip(T.leaves(grads), T.leaves(state.m),
                                T.leaves(state.v), T.leaves(params))]
    new_p = T.unflatten(params, [o[0] for o in out])
    new_m = T.unflatten(params, [o[1] for o in out])
    new_v = T.unflatten(params, [o[2] for o in out])
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm}


def lr_schedule(step: torch.Tensor, *, warmup: int = 100,
                total: int = 10_000, min_frac: float = 0.1
                ) -> torch.Tensor:
    """Linear warmup + cosine decay multiplier (0 at step 0, as the
    reference's: the first step changes parameters only by rounding)."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
