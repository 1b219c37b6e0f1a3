"""Elastic mesh selection and checkpoint resharding on restart
(counterpart of ``repro.ft.elastic``).

After a node failure the job restarts with whatever ranks survive.
``choose_mesh_shape(n)`` picks the largest usable ``(data, model)`` grid
(``(pod, data, model)`` with ``pods``), model parallelism capped so TP
stays intra-pod-sized; ``make_elastic_mesh`` lays it over the
``torch.distributed`` world, the ranks past the grid leaving it (JAX
drops them with ``devices[:used]``); ``reshard_restore`` loads a
checkpoint written on any mesh (whole leaves on disk) as this rank's
slices.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shd

PREFERRED_TP = (16, 8, 4, 2, 1)


def choose_mesh_shape(n_devices: int, *, want_tp: int = 16,
                      pods: int = 1) -> Tuple[Tuple[int, ...],
                                              Tuple[str, ...]]:
    """Largest (pod, data, model) grid for n_devices (drops stragglers)."""
    per_pod = n_devices // pods
    for tp in PREFERRED_TP:
        if tp > want_tp:
            continue
        if per_pod % tp == 0 and per_pod // tp >= 1:
            dp = per_pod // tp
            if pods > 1:
                return (pods, dp, tp), ("pod", "data", "model")
            return (dp, tp), ("data", "model")
    return (n_devices,), ("data",)


def make_elastic_mesh(*, want_tp: int = 16, pods: int = 1, backend: str,
                      timeout_s: float = 300.0):
    """The ``choose_mesh_shape`` grid over the ranks of the default
    process group (which must be up: ``dist.init_process_group`` with
    ``backend``). Every rank must call it; a rank past the grid gets
    ``None`` and takes no part in the mesh's collectives."""
    if not dist.is_initialized():
        raise RuntimeError("join the process group first "
                           "(torch.distributed.init_process_group)")
    shape, axes = choose_mesh_shape(dist.get_world_size(), want_tp=want_tp,
                                    pods=pods)
    return meshlib.grid_mesh(shape, axes, backend=backend,
                             timeout_s=timeout_s)


def reshard_restore(tree_like, directory: str, mesh, spec_fn,
                    step: Optional[int] = None):
    """Restore a checkpoint written on any mesh onto ``mesh``:
    ``tree_like`` holds this rank's slices (structure, dtypes, devices),
    ``spec_fn(path, whole array, mesh)`` gives each leaf's spec
    (``launch.sharding.param_spec``; ``functools.partial(param_spec,
    cfg=cfg)`` where the model's heads may not divide ``model``). Returns
    ``(tree, step)``."""
    return ckpt.restore(tree_like, directory, step=step,
                        slice_fn=shd.restore_slicer(mesh, spec_fn))
