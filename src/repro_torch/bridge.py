"""Carry weights and arenas across from numpy (the parity tests feed the
JAX package's parameter trees through here).

``params_from_numpy(tree, device)`` takes a parameter tree of nested
dicts of numpy arrays. A QTensor leaf arrives as a dict of its six fields
(``in_codes`` already widened to int8) plus ``shape``, ``bits_in``,
``bits_out`` and ``subtile``, with any leading stack dims: ``[G]`` (a
per-group stack) becomes a per-group list of :class:`QTensor`. Two
leading dims are ambiguous — a ``ShardedQTensor`` stacked over groups is
``[G, S, ...]``, an MoE expert stack ``[G, E, ...]``, and either may be
1 — so such a leaf must carry ``"stack"``: ``"shards"`` or ``"experts"``
(a ``[G][E]`` nested list); an unmarked one is refused. A shard stack
with ``S = 1`` drops its shard dim (a per-group list of QTensors), one
with ``S > 1`` becomes a per-group list of :class:`ShardedQTensor` (it
carries ``shard_axis`` and ``n_shards``; an unstacked one ``[S, ...]``
is marked ``"shards"`` too). Dense leaves become tensors, group-stacked
leaves keep their ``[G, ...]`` layout.

With ``mesh=`` (a ``launch.mesh.Mesh`` or any object with its
``axis_names``, ``devices`` and ``index``) each returns rank ``(d, m)``'s
part: shard ``m`` of a ``[G, S, ...]`` stack and the slices of the dense
leaves (``launch.sharding.shard_params``), or its slice of the arena's
pages and KV heads (``launch.sharding.shard_arena``); of a ``[G, E]``
expert stack, under expert parallelism (``E % M == 0``), rank ``m``'s
experts, each ``[E]`` list holding ``None`` for the others, and
otherwise every expert cut.

``arena_from_numpy`` / ``arena_to_numpy`` move the paged arena, with the
dense SSM (``ssm``, always fp32) and conv rows of mamba and hybrid
blocks. numpy has no bfloat16, so int8 scale leaves (``*_scale_pages``)
travel as float32 and are cast back to bfloat16 on the way in (exact:
they were bf16); so do the pages and ``conv`` rows of a bf16 arena, cast
back to the ``cache_dtype`` the caller names.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.qtensor import QTensor
from repro_torch.core.qtensor_sharded import ShardedQTensor

_QT_FIELDS = ("in_codes", "out_codes", "stream_pos", "is_out", "scale_in",
              "scale_out")
_DTYPES = {"in_codes": torch.int8, "out_codes": torch.int8,
           "stream_pos": torch.int32, "is_out": torch.bool,
           "scale_in": torch.float32, "scale_out": torch.float32}


def _qtensor(fields: dict, device) -> QTensor:
    def t(name):
        return torch.tensor(np.asarray(fields[name])).to(
            device=device, dtype=_DTYPES[name]).contiguous()
    return QTensor(*(t(f) for f in _QT_FIELDS),
                   shape=tuple(int(v) for v in fields["shape"]),
                   bits_in=int(fields["bits_in"]),
                   bits_out=int(fields["bits_out"]),
                   subtile=tuple(int(v) for v in fields["subtile"]))


def _unstack(fields: dict, device):
    """A QTensor, or a (nested) list of them over the leading dims."""
    if np.ndim(fields["in_codes"]) == 3:         # [k, r, c]
        return _qtensor(fields, device)
    return [_unstack(dict(fields, **{f: np.asarray(fields[f])[i]
                                     for f in _QT_FIELDS}), device)
            for i in range(np.shape(fields["in_codes"])[0])]


def _sharded(fields: dict, device) -> ShardedQTensor:
    """A ``[S, ...]`` ShardedQTensor."""
    def t(name):
        return torch.tensor(np.asarray(fields[name])).to(
            device=device, dtype=_DTYPES[name]).contiguous()
    return ShardedQTensor(*(t(f) for f in _QT_FIELDS),
                          shape=tuple(int(v) for v in fields["shape"]),
                          bits_in=int(fields["bits_in"]),
                          bits_out=int(fields["bits_out"]),
                          subtile=tuple(int(v) for v in fields["subtile"]),
                          shard_axis=int(fields["shard_axis"]),
                          n_shards=int(fields["n_shards"]))


def _qtensor_leaf(fields: dict, device):
    extra = np.ndim(fields["in_codes"]) - 3      # [k, r, c] is rank 3
    stack = fields.get("stack")
    if extra == 1 and stack == "shards":         # [S, ...]
        return _sharded(fields, device)
    if extra == 2:
        if stack == "shards":                    # [G, S, ...]
            if np.shape(fields["in_codes"])[1] > 1:
                return [_sharded(dict(fields, **{
                    f: np.asarray(fields[f])[g] for f in _QT_FIELDS}),
                    device) for g in range(np.shape(fields["in_codes"])[0])]
            fields = dict(fields, **{f: np.asarray(fields[f])[:, 0]
                                     for f in _QT_FIELDS})
        elif stack != "experts":                 # [G, E, ...]
            raise ValueError(
                "a QTensor with two stack dims must say whether they are "
                "[G, shards] or [G, experts] (\"stack\")")
    elif extra > 2:
        raise ValueError(f"unexpected QTensor stack rank {extra}")
    return _unstack(fields, device)


def params_from_numpy(tree, device="cuda", mesh=None):
    """The port's parameter tree from nested dicts of numpy arrays (with
    ``mesh``, this rank's part of it)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            if "in_codes" in node:
                return _qtensor_leaf(node, dev)
            return {k: walk(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node)).to(dev)
    out = walk(tree)
    if mesh is not None:
        from repro_torch.launch.sharding import shard_params
        out = shard_params(out, mesh)
    return out


def arena_from_numpy(tree, device="cuda", cache_dtype=None, mesh=None):
    """The paged arena from nested dicts of numpy arrays (JAX layout);
    ``cache_dtype`` (e.g. ``torch.bfloat16``) is the dtype of the float
    K/V pages and conv rows, when they travelled widened. With ``mesh``,
    this rank's slice of it."""
    dev = resolve_device(device)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        t = torch.tensor(np.asarray(node)).to(dev)
        if name.endswith("_scale_pages"):
            t = t.to(torch.bfloat16)
        elif (cache_dtype is not None and t.is_floating_point()
              and name in ("k_pages", "v_pages", "conv")):
            t = t.to(cache_dtype)
        return t.contiguous()
    out = walk(tree)
    if mesh is not None:
        from repro_torch.launch.sharding import shard_arena
        out = shard_arena(out, mesh)
    return out


def arena_to_numpy(tree):
    """Nested dicts of numpy arrays (bfloat16 leaves as float32)."""
    if isinstance(tree, dict):
        return {k: arena_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
