"""The train steps (counterpart of ``repro.train.step`` and the reference
trainer's ``_single_device_step``): gradients of
``models.model.train_loss`` by ``torch.autograd``, accumulated over
microbatches as the reference's ``_grads_fn`` does, then one AdamW
update at the scheduled learning rate.

The forward runs the plain path (``use_kernels=False``) on dense
parameters: the hand kernels have no backward, as none of the reference's
Pallas kernels has one. ``single_device_step`` runs ``remat=False``, as
the reference's does; ``build_train_step`` is the sharded step on a rank
mesh (FSDP on ``data``, TP on ``model``, the batch over ``(pod, data)``;
``launch.sharding``), rematerialised per layer group by default.

The reference's ``build_train_step`` also returns ``jit_step`` and
``shardings_for``, which give ``jax.jit`` its in/out shardings and
donation. The port has no counterpart of either: its step runs eagerly
on each rank's slices, which the caller makes with
``launch.sharding.train_slices`` (the trainer does), and the layout is
the mesh's (``launch.sharding.train_specs``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import runtime_context as ctx
from repro_torch import tree as T
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, train_loss
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig


def _loss_and_grads(model_cfg: ModelConfig, params, batch, remat: bool,
                    gather):
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    total, metrics = train_loss(model_cfg, T.unflatten(params, leaves),
                                batch, remat=remat, gather=gather)
    # a leaf the loss does not read (the whisper encoder's q/k/v biases,
    # which its layers skip, as the reference's) gets zeros, as under
    # jax.grad
    grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                materialize_grads=True)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            T.unflatten(params, list(grads)))


def grads_fn(model_cfg: ModelConfig, microbatches: int = 1, *,
             remat: bool = False, gather=None) -> Callable:
    """``compute(params, batch) -> (loss, {"loss", "aux"}, grads)``; with
    ``microbatches > 1`` the batch's leading dim is split and the fp32
    gradients, losses and aux losses are averaged over the pieces
    (``repro.train.step._grads_fn``). ``remat`` and ``gather`` (the
    training mesh's FSDP gather) go to ``train_loss``."""
    def compute(params, batch: Dict[str, torch.Tensor]):
        if microbatches <= 1:
            return _loss_and_grads(model_cfg, params, batch, remat, gather)
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{microbatches} microbatches")
        n = rows // microbatches
        grads = T.map_(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss = torch.zeros((), device=T.leaves(params)[0].device)
        aux = torch.zeros_like(loss)
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l, m, g = _loss_and_grads(model_cfg, params, mb, remat, gather)
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


def _sum_grads(grads, specs: dict, mesh, cfg):
    """Each gradient summed over the axes its leaf needs
    (``sharding.grad_axes``): per axis, the leaves that need it flattened
    into one buffer and reduced in one all_reduce."""
    items = list(T.items(grads))
    out = dict(items)
    for axis in ("data", "model", "pod"):
        paths = [p for p, _ in items
                 if axis in shd.grad_axes(p, specs[p], mesh, cfg)]
        if not paths:
            continue
        flat = torch.cat([out[p].reshape(-1) for p in paths])
        mesh.all_reduce(flat, axis, kind="grad_sum")
        off = 0
        for p in paths:
            n = out[p].numel()
            out[p] = flat[off:off + n].view_as(out[p])
            off += n
    return T.unflatten(grads, [out[p] for p, _ in items])


def mesh_grads_fn(model_cfg: ModelConfig, mesh, microbatches: int = 1, *,
                  remat: bool = True) -> Callable:
    """``compute(params, batch) -> (loss, {"loss", "aux"}, grads)`` on a
    training mesh (``repro.train.step._grads_fn`` under GSPMD): this
    rank's slices of the parameters (``launch.sharding.train_slices``)
    and its rows of the global batch (``sharding.batch_rows(mesh, B,
    microbatches)``: split over the dp axes, each rank's share of each
    global microbatch), which ``microbatches`` split (they must divide,
    as the reference's reshape requires). The batch's ``frames`` (an
    encoder-decoder) and ``vis_embeds`` (a VLM) are batch rows like the
    tokens: the rank takes the same rows of them, and the microbatches
    split them alike. Each group's leaves (the encoder's layers and the
    cross-attention's too) are gathered over ``data`` just before use and
    their gradients reduce-scattered back; the TP collectives carry the
    gradients of the column- and row-parallel products, of the Mamba2
    mixer's gather and split and of the MoE block's expert-parallel
    dispatch; each MoE block's capacity, drops and aux are global over
    the dp ranks' rows (``models.moe``). An attention block whose heads
    do not divide ``model``, and an embedding and head whose vocab does
    not, run whole on every model rank, with whole gradients there.
    After the backward pass the leaves replicated over ``data``, the
    column-parallel biases and the MoE router over ``model`` and every
    leaf over ``pod`` are summed there (``sharding.grad_axes``), and the
    gradients scaled by ``1 / dp`` (the global batch's mean is the mean
    of the dp ranks' means). So the gradients come out sharded as their
    parameters, and the loss and aux are the global ones, equal on every
    rank. Every stack but one whose ``d_ff`` does not divide ``model``
    (``sharding.check_train_mesh``). ``compute.specs`` is the mesh's
    ``{path: spec}`` of the parameters."""
    shd.check_train_mesh(model_cfg, mesh)
    specs = shd.train_specs(init_params(model_cfg, device="meta"), mesh,
                            model_cfg)
    local = grads_fn(model_cfg, microbatches, remat=remat,
                     gather=shd.fsdp_gather(specs, mesh))
    dp = meshlib.dp_size(mesh)

    def compute(params, batch):
        if dp > 1 and batch.get("loss_mask") is not None:
            # the mean of the dp ranks' masked means is not the global
            # masked mean (GSPMD's); no batch here carries a mask
            raise NotImplementedError("a loss mask over a dp mesh")
        with ctx.use_mesh(mesh, meshlib.dp_axes(mesh), split_rows=True):
            loss, metrics, grads = local(params, batch)
        grads = _sum_grads(grads, specs, mesh, model_cfg)
        if dp > 1:
            # the aux is the global one already, equal on every rank
            grads = T.map_(lambda g: g * (1.0 / dp), grads)
            sums = torch.stack([loss, metrics["loss"]])
            for axis in meshlib.dp_axes(mesh):
                mesh.all_reduce(sums, axis, kind="metrics")
            loss, metrics = sums[0] / dp, {"loss": sums[1] / dp,
                                           "aux": metrics["aux"]}
        return loss, metrics, grads
    compute.specs = specs
    return compute


def build_train_step(model_cfg: ModelConfig, opt_cfg: AdamWConfig, mesh, *,
                     microbatches: int = 1, warmup: int = 100,
                     total_steps: int = 10_000,
                     remat: bool = True) -> Callable:
    """The sharded step (``repro.train.step.build_train_step``):
    ``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "aux", "grad_norm", "lr"})`` on this rank's slices of the parameters
    and both moments and its rows of the global batch: the gradients of
    ``mesh_grads_fn``, their global norm (``adamw.global_norm`` over the
    mesh), the scheduled learning rate, one AdamW update on the slices.
    The metrics are the global ones, equal on every rank. ``step.specs``
    is the mesh's ``{path: spec}`` of the parameters."""
    compute = mesh_grads_fn(model_cfg, mesh, microbatches, remat=remat)
    owned = {p: shd.owns(s, mesh) for p, s in compute.specs.items()}

    def step(params, opt_state, batch):
        _, metrics, grads = compute(params, batch)
        gnorm = adamw.global_norm(grads, mesh,
                                  [owned[p] for p, _ in T.items(grads)])
        lr_scale = adamw.lr_schedule(opt_state.step, warmup=warmup,
                                     total=total_steps)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             opt_cfg, lr_scale, gnorm=gnorm)
        return params, opt_state, {"loss": metrics["loss"],
                                   "aux": metrics["aux"],
                                   "grad_norm": om["grad_norm"],
                                   "lr": lr_scale * opt_cfg.lr}
    step.specs = compute.specs
    return step
