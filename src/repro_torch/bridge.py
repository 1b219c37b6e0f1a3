"""Carry weights and arenas across from numpy (the parity tests feed the
JAX package's parameter trees through here).

``params_from_numpy(tree, device)`` takes a parameter tree of nested
dicts of numpy arrays. A QTensor leaf arrives as a dict of its six fields
(``in_codes`` already widened to int8) plus ``shape``, ``bits_in``,
``bits_out`` and ``subtile``, with any leading ``[G]`` or ``[G, 1]``
stack dims (a stacked one-shard ``ShardedQTensor``); it becomes one
:class:`QTensor` or a per-group list of them. Dense leaves become
tensors, group-stacked leaves keep their ``[G, ...]`` layout.

``arena_from_numpy`` / ``arena_to_numpy`` move the paged arena. numpy has
no bfloat16, so int8 scale leaves (``*_scale_pages``) travel as float32
and are cast back to bfloat16 on the way in (exact: they were bf16).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.qtensor import QTensor

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


def _qtensor_leaf(fields: dict, device):
    extra = np.ndim(fields["in_codes"]) - 3      # [k, r, c] is rank 3
    if extra == 0:
        return _qtensor(fields, device)
    if extra == 2:                               # [G, 1, ...]: one shard
        if np.shape(fields["in_codes"])[1] != 1:
            raise ValueError("only one-shard stacks are ported")
        fields = dict(fields, **{f: np.asarray(fields[f])[:, 0]
                                 for f in _QT_FIELDS})
    elif extra != 1:
        raise ValueError(f"unexpected QTensor stack rank {extra}")
    g = np.shape(fields["in_codes"])[0]
    return [_qtensor(dict(fields, **{f: np.asarray(fields[f])[i]
                                     for f in _QT_FIELDS}), device)
            for i in range(g)]


def params_from_numpy(tree, device="cuda"):
    """The port's parameter tree from nested dicts of numpy arrays."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            if "in_codes" in node:
                return _qtensor_leaf(node, dev)
            return {k: walk(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node)).to(dev)
    return walk(tree)


def arena_from_numpy(tree, device="cuda"):
    """The paged arena from nested dicts of numpy arrays (JAX layout)."""
    dev = resolve_device(device)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        t = torch.tensor(np.asarray(node)).to(dev)
        if name.endswith("_scale_pages"):
            t = t.to(torch.bfloat16)
        return t.contiguous()
    return walk(tree)


def arena_to_numpy(tree):
    """Nested dicts of numpy arrays (bfloat16 leaves as float32)."""
    if isinstance(tree, dict):
        return {k: arena_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
