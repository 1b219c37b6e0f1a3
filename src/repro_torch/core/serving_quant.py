"""Model-level QMC serving-format conversion.

``quantize_for_serving(params, qmc, tp_shards=1)`` converts eligible
weight leaves of a parameter tree into the deployment format, as
``repro.core.serving_quant`` does:

  * stacked projections ``[G, din, dout]`` -> a per-group list of
    :class:`QTensor` (the JAX walk stacks the fields of a one-shard
    ``ShardedQTensor`` instead); with ``tp_shards = S > 1``, a per-group
    list of :class:`ShardedQTensor` of S shards where each shard tiles
    (quantize-after-shard: every shard quantized on its own), cut over
    the input dim for the row-parallel ``ROW_SHARDED`` projections and
    over the output dim for the rest, else a QTensor of the whole
    weight, as JAX falls back to one shard;
  * MoE expert stacks ``[G, E, din, dout]`` -> a ``[G][E]`` nested list
    of QTensors (the JAX walk stacks a plain QTensor's fields over
    ``[G, E]``);
  * unstacked 2-D projections (``lm_head``) -> one QTensor (or one
    ShardedQTensor, cut over the vocab);
  * everything else (norms, embeddings, biases, small or non-tileable
    leaves) stays dense.

``build_exec_weights(params)`` is the serving **weight plan**: every
stream leaf dequantized once into a dense fp32 tensor of its logical shape,
so the step multiplies dense weights (a ``[G][E]`` expert list becomes
one ``[G, E, din, dout]`` tensor, multiplied by ``torch.bmm``). The port's engine keeps it as a
switch (``weight_plan``), off by default: the streams go through the qmm
kernels.

``only_shard=m`` quantizes shard ``m`` of every sharded leaf alone (the
fields hold one shard, ``first = m``): what TP rank ``m`` does on its
own slice of the weights, which equals the whole conversion's shard
``m``. On an expert stack whose ``E`` the ``tp_shards`` divide it
quantizes rank ``m``'s experts ``[m E/S, (m + 1) E/S)`` alone (expert
parallelism, ``launch.sharding.expert_range``): each ``[E]`` list keeps
its length, with ``None`` where another rank holds the expert, and each
held expert equals the whole conversion's. Otherwise every expert is
converted whole, as JAX's conversion does, and the mesh cuts it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.apply import is_quantizable
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import (QTensor, dequantize_qtensor,
                                      quantize_qtensor)
from repro_torch.core.qtensor_sharded import (ShardedQTensor,
                                              dequantize_sharded,
                                              quantize_qtensor_sharded)


ROW_SHARDED = ("wo", "w_down", "out_proj")   # TP shards the input dim


def _shard_axis_for(path: str) -> int:
    name = path.split("/")[-1]
    return 0 if name in ROW_SHARDED else 1


def _tileable(din: int, dout: int, cfg: QMCConfig, shards: int = 1,
              shard_axis: int = 1) -> bool:
    r, c = cfg.subtile
    d0, d1 = din, dout
    if shard_axis == 0:
        d0 = din // shards if din % shards == 0 else 0
    else:
        d1 = dout // shards if dout % shards == 0 else 0
    return d0 >= r and d1 >= c and d0 % r == 0 and d1 % c == 0


def _convert_leaf(path: str, leaf: torch.Tensor, cfg: QMCConfig,
                  shards: int, only: Optional[int]):
    din, dout = leaf.shape[-2:]
    sa = _shard_axis_for(path)
    moe = leaf.ndim == 4                 # [G, E, d, ff]: one shard
    eff = shards if not moe and _tileable(din, dout, cfg, shards, sa) \
        else 1
    if not _tileable(din, dout, cfg, eff, sa):
        return leaf

    if moe:                              # [G][E] lists of QTensors
        g, e = leaf.shape[:2]
        lo, hi = 0, e
        if only is not None and shards > 1 and e % shards == 0:
            lo, hi = only * (e // shards), (only + 1) * (e // shards)
        return [[quantize_qtensor(leaf[gi, ei], cfg) if lo <= ei < hi
                 else None for ei in range(e)] for gi in range(g)]

    def convert(w):
        if w.ndim == 2:
            if eff == 1:
                return quantize_qtensor(w, cfg)
            return quantize_qtensor_sharded(w, cfg, eff, sa, only=only)
        return [convert(w[i]) for i in range(w.shape[0])]
    return convert(leaf)


def quantize_for_serving(params, qmc: QMCConfig, min_dim: int = 128,
                         tp_shards: int = 1,
                         only_shard: Optional[int] = None):
    """Convert a parameter tree (nested dicts of tensors) to the serving
    format; quantization runs on the device the leaves lie on."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        if is_quantizable(path, tree, min_dim):
            return _convert_leaf(path, tree, qmc, tp_shards, only_shard)
        return tree
    return walk(params, "")


def is_stream_leaf(leaf) -> bool:
    """A QTensor or ShardedQTensor, or a (nested) per-group / per-expert
    list of them (an expert list may hold ``None`` for the experts other
    ranks hold)."""
    if isinstance(leaf, list):
        held = [q for q in leaf if q is not None]
        return bool(held) and is_stream_leaf(held[0])
    return isinstance(leaf, (QTensor, ShardedQTensor))


def build_exec_weights(params, dtype=torch.float32):
    """Lower every stream leaf to a dense ``dtype`` tensor (stacked [G]
    lists become one [G, din, dout] tensor, [G][E] lists one [G, E, din,
    dout]); dense leaves pass through."""
    def lower(tree):
        if isinstance(tree, dict):
            return {k: lower(v) for k, v in tree.items()}
        if isinstance(tree, QTensor):
            return dequantize_qtensor(tree, dtype)
        if isinstance(tree, ShardedQTensor):
            return dequantize_sharded(tree, dtype)
        if is_stream_leaf(tree):
            return torch.stack([lower(q) for q in tree])
        return tree
    return lower(params)
