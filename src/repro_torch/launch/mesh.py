"""The rank mesh over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

``make_mesh((D, M), ("data", "model"), backend=...)`` lays the ranks of
one process group out as a ``(data, model)`` grid: rank ``d * M + m`` sits
at ``(d, m)``, the order of JAX's ``reshape(shape)`` over its device list.
It keeps one process group per ``data`` line (the ranks that share ``m``)
and one per ``model`` line (the ranks that share ``d``); a rank's
collectives over an axis run in its own line's group, and ``"all"``
names the group of every rank of the grid. A third ``pod`` axis
(``("pod", "data", "model")``, pure data parallelism in training) gets
its lines the same way. ``dp_axes``,
``tp_axis``, ``axis_size`` and ``dp_size`` keep their JAX meanings and
take any object with ``axis_names`` and ``devices.shape``.

The backend is always the caller's: ``"nccl"`` for one card per rank,
``"gloo"`` for the CPU and for several ranks on one card (NCCL refuses
two ranks on one device). Nothing here picks one by falling back. Every
collective waits at most the group's ``timeout``, so a rank never waits
forever on a dead peer.

``spawn(fn, (D, M), backend=..., args=...)`` runs ``fn(mesh, *args)`` in
``D * M`` fresh processes (file rendezvous in a temporary directory; the
axes are ``default_axes(shape)``) and returns each rank's result in rank
order (by value, pickled); a rank that raises or outlives ``timeout_s``
ends every rank and raises here. CUDA tensors in ``args`` reach the ranks
through CUDA IPC, without a copy. ``grid_mesh`` lays a grid over the
first ranks of a group that is already up, the others taking no part
(``ft.elastic``). Every collective is tallied by kind in ``Mesh.by_kind``
(calls, seconds, payload bytes: the collective's whole buffer, i.e. an
all_reduce's tensor, a gather's output, a reduce-scatter's input) beside
the totals. ``make_production_mesh`` (the v5e pod shapes) is left for the
cost tooling (ROADMAP A13).
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class Mesh:
    """One rank's view of the ``(data, model)`` grid: its ``rank``,
    ``coords`` (axis name -> index), ``devices`` (the grid of ranks, as
    JAX's ``Mesh.devices``) and one process group per axis line it sits
    on, and ``"all"`` (``None`` for a group of one rank, whose
    collectives are no-ops)."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 rank: int, backend: str, groups: dict,
                 timeout: datetime.timedelta):
        self.shape = tuple(shape)
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(int(np.prod(self.shape))).reshape(
            self.shape)
        self.rank = rank
        self.backend = backend
        self.groups = groups
        self.timeout = timeout
        where = np.argwhere(self.devices == rank)[0]
        self.coords = {a: int(i) for a, i in zip(self.axis_names, where)}
        self.collectives = 0          # calls that crossed ranks
        self.collective_seconds = 0.0
        self.by_kind: dict = {}       # kind -> [calls, seconds, bytes]

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def _tally(self, kind: str, t0: float, nbytes: int) -> None:
        dt = time.perf_counter() - t0
        self.collectives += 1
        self.collective_seconds += dt
        row = self.by_kind.setdefault(kind, [0, 0.0, 0])
        row[0] += 1
        row[1] += dt
        row[2] += nbytes

    def reset_counts(self) -> None:
        self.collectives, self.collective_seconds = 0, 0.0
        self.by_kind = {}

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum",
                   kind: str = "serve") -> torch.Tensor:
        """In-place all-reduce of ``t`` over this rank's ``axis`` line
        (``"all"``: every rank of the grid)."""
        group = self.groups.get(axis)
        if group is None:
            return t
        t0 = time.perf_counter()
        dist.all_reduce(t, op=_OPS[op], group=group)
        self._tally(kind, t0, t.numel() * t.element_size())
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int,
                   kind: str) -> torch.Tensor:
        """Every rank's ``t`` of this rank's ``axis`` line, concatenated
        along ``dim`` in the line's order (``all_gather_into_tensor``
        along dim 0, ``dim`` moved there and back)."""
        group = self.groups.get(axis)
        if group is None:
            return t
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((axis_size(self, axis) * src.shape[0],
                             *src.shape[1:]))
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(out, src, group=group)
        self._tally(kind, t0, out.numel() * out.element_size())
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int,
                       kind: str) -> torch.Tensor:
        """``t`` summed over this rank's ``axis`` line, and of the sum
        only this rank's block along ``dim`` (``reduce_scatter_tensor``
        along dim 0, ``dim`` moved there and back)."""
        group = self.groups.get(axis)
        if group is None:
            return t
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // axis_size(self, axis),
                             *src.shape[1:]))
        t0 = time.perf_counter()
        dist.reduce_scatter_tensor(out, src, op=_OPS["sum"], group=group)
        self._tally(kind, t0, src.numel() * src.element_size())
        return out.movedim(0, dim).contiguous()


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              backend: str, init_method: Optional[str] = None,
              rank: Optional[int] = None,
              world_size: Optional[int] = None,
              timeout_s: float = 300.0) -> Mesh:
    """The mesh of this process. Joins the default process group first
    when it is not up (``init_method`` with ``rank`` and ``world_size``,
    or the ``env://`` variables ``torchrun`` sets); the group's world size
    must be ``prod(shape)``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    n = int(np.prod(shape))
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(
                                    seconds=timeout_s))
    if dist.get_world_size() != n:
        raise ValueError(f"need {n} ranks, have {dist.get_world_size()}")
    return grid_mesh(shape, axes, backend=backend, timeout_s=timeout_s)


def grid_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              backend: str, timeout_s: float = 300.0) -> Optional[Mesh]:
    """The ``shape`` grid over ranks ``0 .. prod(shape) - 1`` of the
    default process group, which must be up with at least that many
    ranks. Every rank of the group must call it (``new_group`` is
    collective); a rank past the grid gets ``None``."""
    n = int(np.prod(shape))
    if dist.get_world_size() < n:
        raise ValueError(f"need {n} ranks, have {dist.get_world_size()}")
    timeout = datetime.timedelta(seconds=timeout_s)
    me = dist.get_rank()
    grid = np.arange(n).reshape(shape)
    groups = {}
    for i, axis in enumerate(axes):
        # every rank creates every line's group, in the same order
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:
            ranks = [int(r) for r in line]
            g = (dist.new_group(ranks, backend=backend, timeout=timeout)
                 if shape[i] > 1 else None)
            if me in ranks:
                groups[axis] = g
    groups["all"] = (dist.new_group(list(range(n)), backend=backend,
                                    timeout=timeout) if n > 1 else None)
    if me >= n:
        return None
    return Mesh(shape, axes, me, backend, groups, timeout)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel submesh axes (pod + data when present)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def tp_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def axis_size(mesh, name) -> int:
    if name is None:
        return 1
    names = list(mesh.axis_names)
    if name not in names:
        return 1
    return mesh.devices.shape[names.index(name)]


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= axis_size(mesh, a)
    return n


def dp_index(mesh) -> int:
    """This rank's index over the dp axes, ``pod``-major (the order JAX
    lays a ``(pod, data)`` spec entry out in)."""
    k = 0
    for a in dp_axes(mesh):
        k = k * axis_size(mesh, a) + mesh.index(a)
    return k


# ---------------------------------------------------------------------------
# spawning the ranks of one mesh
# ---------------------------------------------------------------------------
def default_axes(shape: Sequence[int]) -> Tuple[str, ...]:
    """``("data", "model")`` for a 2-D shape, ``("pod", "data",
    "model")`` for a 3-D one."""
    return {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(shape)]


def _rank_main(rank: int, world: int, shape, backend: str, init_file: str,
               timeout_s: float, fn: Callable, args, results) -> None:
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        mesh = make_mesh(tuple(shape), default_axes(shape), backend=backend,
                         init_method=f"file://{init_file}", rank=rank,
                         world_size=world, timeout_s=timeout_s)
        # by value: a tensor shared through the queue would need this
        # process alive after it returns
        results.put((rank, True, pickle.dumps(fn(mesh, *args))))
    except BaseException:                       # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, shape: Sequence[int], *, backend: str,
          args: tuple = (), timeout_s: float = 600.0) -> list:
    """``fn(mesh, *args)`` on every rank of a ``shape`` mesh (axes
    ``default_axes(shape)``), each in a fresh process;
    returns the ranks' results in rank order. ``fn`` must
    be importable by name (a module-level function). A rank that raises,
    dies or is still running after ``timeout_s`` ends every rank, and the
    first rank's error is raised here."""
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    world = int(np.prod(shape))
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="qmc-mesh-") as tmpdir:
        init_file = os.path.join(tmpdir, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, tuple(shape), backend,
                                   init_file, min(timeout_s, 300.0), fn,
                                   args, results), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        out: dict = {}
        error: Optional[str] = None
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world and error is None:
                try:
                    rank, ok, val = results.get(timeout=0.2)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        error = (f"rank {dead[0]} exited with code "
                                 f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        error = f"mesh {tuple(shape)} timed out after " \
                                f"{timeout_s:.0f} s"
                    continue
                if ok:
                    out[rank] = pickle.loads(val)
                else:
                    error = f"rank {rank} raised:\n{val}"
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic())
                       if error is None else 1.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
    if error is not None:
        raise RuntimeError(error)
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"rank {bad[0]} exited with code "
                           f"{procs[bad[0]].exitcode}")
    return [out[r] for r in range(world)]


__all__ = ["Mesh", "make_mesh", "grid_mesh", "default_axes", "dp_axes",
           "tp_axis", "axis_size", "dp_size", "dp_index", "spawn",
           "BACKENDS"]
