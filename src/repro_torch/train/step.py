"""The single-device train step (counterpart of the single-device part of
``repro.train``): gradients of ``models.model.train_loss`` by
``torch.autograd``, accumulated over microbatches as the reference's
``_grads_fn`` does, then one AdamW update at the scheduled learning rate
(the reference trainer's ``_single_device_step``).

The forward runs the plain path (``use_kernels=False``) on dense
parameters: the hand kernels have no backward, as none of the reference's
Pallas kernels has one. No rematerialisation: the single-device reference
runs ``remat=False``. The sharded step (``build_train_step`` with a mesh)
waits for the multi-GPU item (ROADMAP A12).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import tree as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import train_loss
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig


def _loss_and_grads(model_cfg: ModelConfig, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    total, metrics = train_loss(model_cfg, T.unflatten(params, leaves),
                                batch)
    grads = torch.autograd.grad(total, leaves)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            T.unflatten(params, list(grads)))


def grads_fn(model_cfg: ModelConfig, microbatches: int = 1) -> Callable:
    """``compute(params, batch) -> (loss, {"loss", "aux"}, grads)``; with
    ``microbatches > 1`` the batch's leading dim is split and the fp32
    gradients, losses and aux losses are averaged over the pieces
    (``repro.train.step._grads_fn``)."""
    def compute(params, batch: Dict[str, torch.Tensor]):
        if microbatches <= 1:
            return _loss_and_grads(model_cfg, params, batch)
        n = next(iter(batch.values())).shape[0] // microbatches
        grads = T.map_(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss = torch.zeros((), device=T.leaves(params)[0].device)
        aux = torch.zeros_like(loss)
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l, m, g = _loss_and_grads(model_cfg, params, mb)
            grads = T.map_(lambda a, b: a + b.to(torch.float32), grads, g)
            loss, aux = loss + l, aux + m["aux"]
        inv = 1.0 / microbatches
        grads = T.map_(lambda g: g * inv, grads)
        return loss * inv, {"loss": loss * inv, "aux": aux * inv}, grads
    return compute


def single_device_step(model_cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                       warmup: int, total_steps: int,
                       microbatches: int = 1) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss's gradients (over ``microbatches`` pieces of the batch), the
    learning rate scheduled at the state's step count before the update
    (0 at step 0, as the reference's), one AdamW update."""
    compute = grads_fn(model_cfg, microbatches)

    def step(params, opt_state, batch):
        _, metrics, grads = compute(params, batch)
        lr_scale = adamw.lr_schedule(opt_state.step, warmup=warmup,
                                     total=total_steps)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             opt_cfg, lr_scale)
        return params, opt_state, {"loss": metrics["loss"],
                                   "aux": metrics["aux"],
                                   "grad_norm": om["grad_norm"],
                                   "lr": lr_scale * opt_cfg.lr}
    return step


def build_train_step(*args, **kwargs):
    """The reference's sharded train step needs a device mesh."""
    raise NotImplementedError(
        "the sharded train step (a mesh over several GPUs) is not ported "
        "yet (ROADMAP A12); train on one device with "
        "train.trainer.train")
