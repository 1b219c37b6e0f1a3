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

``serving_params_struct`` gives the same tree with no value computed
(``meta`` streams at the shapes the conversion gives), for the dry run.

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


def qtensor_struct(w: torch.Tensor, cfg: QMCConfig) -> QTensor:
    """The QTensor ``quantize_qtensor(w, cfg)`` gives, as ``meta`` tensors
    of its shapes and dtypes: ``round(rho * n_sub)`` outlier subtiles
    (``core.partition.subtile_outlier_mask``), each stream at least one
    subtile long."""
    r, c = cfg.subtile
    din, dout = w.shape
    gr, gc = din // r, dout // c
    k_out = int(round(cfg.rho * gr * gc))
    k_out = min(max(k_out, 0), gr * gc)
    k_in = gr * gc - k_out

    def e(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    return QTensor(
        in_codes=e((max(k_in, 1), r, c), torch.int8),
        out_codes=e((max(k_out, 1), r, c), torch.int8),
        stream_pos=e((gr, gc), torch.int32), is_out=e((gr, gc), torch.bool),
        scale_in=e((1, dout), torch.float32),
        scale_out=e((1, dout), torch.float32),
        shape=(din, dout), bits_in=cfg.bits_in, bits_out=cfg.bits_out,
        subtile=(r, c))


def _sharded_struct(w: torch.Tensor, cfg: QMCConfig, n_shards: int,
                    shard_axis: int = 1,
                    only: Optional[int] = None) -> ShardedQTensor:
    """``quantize_qtensor_sharded``'s result as ``meta`` tensors."""
    shard = list(w.shape)
    shard[shard_axis] //= n_shards
    one = qtensor_struct(torch.empty(shard, device="meta"), cfg)
    n = n_shards if only is None else 1
    return ShardedQTensor(
        *(torch.empty((n,) + tuple(getattr(one, f).shape),
                      dtype=getattr(one, f).dtype, device="meta")
          for f in ("in_codes", "out_codes", "stream_pos", "is_out",
                    "scale_in", "scale_out")),
        shape=tuple(w.shape), bits_in=cfg.bits_in, bits_out=cfg.bits_out,
        subtile=tuple(cfg.subtile), shard_axis=shard_axis,
        n_shards=n_shards, first=0 if only is None else only)


def _convert_leaf(path: str, leaf: torch.Tensor, cfg: QMCConfig,
                  shards: int, only: Optional[int],
                  quantize=quantize_qtensor,
                  quantize_sharded=quantize_qtensor_sharded):
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
        return [[quantize(leaf[gi, ei], cfg) if lo <= ei < hi
                 else None for ei in range(e)] for gi in range(g)]

    def convert(w):
        if w.ndim == 2:
            if eff == 1:
                return quantize(w, cfg)
            return quantize_sharded(w, cfg, eff, sa, only=only)
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


def serving_params_struct(params, qmc: QMCConfig, min_dim: int = 128,
                          tp_shards: int = 1,
                          only_shard: Optional[int] = None):
    """``quantize_for_serving``'s tree with no value computed (the dry
    run; JAX's ``serving_params_struct``): every leaf it would convert
    becomes a QTensor or ShardedQTensor of ``device="meta"`` tensors at
    the shapes that conversion gives (``params`` may be a ``meta`` tree);
    the rest pass through."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        if is_quantizable(path, tree, min_dim):
            return _convert_leaf(path, tree, qmc, tp_shards, only_shard,
                                 quantize=qtensor_struct,
                                 quantize_sharded=_sharded_struct)
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
