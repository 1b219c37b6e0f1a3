"""Collectives with gradients over the rank mesh (the port's own: GSPMD
places the JAX package's collectives itself, so it has no counterpart).

An in-place ``dist.all_reduce`` is invisible to autograd, so a backward
through one gives silently wrong gradients. The functions here are
``torch.autograd.Function``s on the mesh's groups, and every call counts
in ``Mesh.collectives`` / ``collective_seconds`` and in
``Mesh.by_kind`` under its kind:

  * ``copy_to(x, mesh)``: the identity forward, a SUM over ``model``
    backward (a column-parallel input, Megatron's ``f``; kind ``tp``);
  * ``sum_over(x, mesh, kind)``: a SUM over ``model`` forward, the
    identity backward (after a row-parallel product, a vocab-parallel
    lookup, the vocab-parallel losses' ``se`` and gold logit: ``g``);
  * ``gather_over(w, mesh, dim)``: the FSDP gather of a leaf's sharded
    ``dim`` over ``data`` forward, a reduce-scatter SUM backward;
  * ``max_over(x, mesh)``: a MAX over ``model`` without a gradient (the
    losses' shift, whose gradient is zero in exact arithmetic; kind
    ``loss``);
  * ``gather_model(x, mesh, dim)``: every model rank's equal slice of
    ``x`` along ``dim`` concatenated, for a consumer that runs replicated
    on every model rank (the Mamba2 mixer after the column-parallel
    ``in_proj``, its conv weight); the backward keeps this rank's slice
    of the gradient, which that consumer makes whole and equal on every
    model rank (kind ``gather``);
  * ``split_model(x, mesh, dim)``: this rank's slice of a replicated
    ``x`` along ``dim``, into a row-parallel product (the mixer's ``y``
    into ``out_proj``); the backward gathers the slices' gradients over
    ``model``, so the replicated producer gets the whole gradient (kind
    ``split``);
  * ``sum_dp(x, mesh, axes)``: a SUM over the dp ``axes`` the batch's
    rows are split over (the MoE block's global statistics: the router's
    probability mass, the top-1 and assignment counts per expert); the
    backward scales the gradient by the number of dp ranks, since every
    dp rank's loss carries the same global term and the step then
    divides the summed gradients by that number (kind ``moe_dp``).

One implementation per collective, the same on every host: gloo runs
``all_reduce``, ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
on CUDA tensors (chip_smoke's gloo probe), so a gather is
``Mesh.all_gather`` and a reduce-scatter ``Mesh.reduce_scatter``. Off
the autograd graph (``torch.no_grad``, or a tensor that needs no
gradient: serving) ``sum_over`` keeps serving's in-place all_reduce and
``copy_to`` is the identity, so serving's tokens and launches stay as
they were.

Every rank must run the same collectives in the same order; a
rematerialised group re-runs its forward's collectives in the backward
pass, on every rank alike.
"""
from __future__ import annotations

import torch


def _needs_graph(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _size(mesh, axis: str) -> int:
    return 1 if mesh.groups.get(axis) is None else \
        mesh.devices.shape[list(mesh.axis_names).index(axis)]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        return ctx.mesh.all_reduce(g, "model", kind="tp"), None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, kind):
        return mesh.all_reduce(x.contiguous().clone(), "model", kind=kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _slice(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This model rank's block of ``x`` along ``dim`` (a view)."""
    n = x.shape[dim] // _size(mesh, "model")
    return x.narrow(dim, mesh.index("model") * n, n)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, "model", dim, kind="gather")

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.mesh, ctx.dim).contiguous(), None, None


class _SplitModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _slice(x, mesh, dim).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, "model", ctx.dim,
                                   kind="split"), None, None


class _SumDp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, kind):
        ctx.n = 1
        y = x.contiguous().clone()
        for ax in axes:
            ctx.n *= _size(mesh, ax)
            mesh.all_reduce(y, ax, kind=kind)
        return y

    @staticmethod
    def backward(ctx, g):
        return g * float(ctx.n), None, None, None


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(w, "data", dim, kind="fsdp_gather")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, "data", ctx.dim,
                                       kind="reduce_scatter"), None, None


def copy_to(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as is; its gradient summed over ``model`` in the backward."""
    if _size(mesh, "model") == 1 or not _needs_graph(x):
        return x
    return _CopyTo.apply(x, mesh)


def sum_over(x: torch.Tensor, mesh, kind: str = "tp") -> torch.Tensor:
    """``x`` summed over ``model``; the gradient passes through as is.
    Off the graph, in place (serving's route)."""
    if _size(mesh, "model") == 1:
        return x
    if not _needs_graph(x):
        return mesh.all_reduce(x, "model", kind=kind)
    return _SumOver.apply(x, mesh, kind)


def gather_over(w: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's ``w`` of the ``data`` line concatenated along ``dim``
    (an FSDP leaf made whole along its sharded dim); the gradient
    reduce-scattered back (summed over ``data``, this rank's block
    kept)."""
    if _size(mesh, "data") == 1:
        return w
    if not _needs_graph(w):
        return mesh.all_gather(w, "data", dim, kind="fsdp_gather")
    return _GatherOver.apply(w, mesh, dim)


def max_over(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise MAX of ``x`` over ``model``, detached."""
    x = x.detach()
    if _size(mesh, "model") == 1:
        return x
    return mesh.all_reduce(x.contiguous().clone(), "model", "max",
                           kind="loss")


def gather_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim``; the gradient's
    block of this rank kept in the backward. Off the graph, serving's
    ``Mesh.all_gather``."""
    if _size(mesh, "model") == 1:
        return x
    if not _needs_graph(x):
        return mesh.all_gather(x, "model", dim, kind="gather")
    return _GatherModel.apply(x, mesh, dim)


def split_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This model rank's block of ``x`` along ``dim``; the blocks'
    gradients gathered over ``model`` in the backward. Off the graph, the
    plain slice (serving's)."""
    if _size(mesh, "model") == 1:
        return x
    if not _needs_graph(x):
        return _slice(x, mesh, dim)
    return _SplitModel.apply(x, mesh, dim)


def sum_dp(x: torch.Tensor, mesh, axes, kind: str = "moe_dp"
           ) -> torch.Tensor:
    """``x`` summed over the dp ``axes`` (each in turn); the gradient
    times their ranks in the backward. Off the graph, in place."""
    axes = tuple(a for a in axes if _size(mesh, a) > 1)
    if not axes:
        return x
    if not _needs_graph(x):
        for ax in axes:
            mesh.all_reduce(x, ax, kind=kind)
        return x
    return _SumDp.apply(x, mesh, axes, kind)


__all__ = ["copy_to", "sum_over", "gather_over", "max_over",
           "gather_model", "split_model", "sum_dp"]
