"""Model-level QMC serving-format conversion (single shard).

``quantize_for_serving(params, qmc)`` converts eligible weight leaves of
a parameter tree into the deployment format, as
``repro.core.serving_quant`` does for ``tp_shards=1``:

  * stacked projections ``[G, din, dout]`` -> a per-group list of
    :class:`QTensor` (the JAX walk stacks the fields of a one-shard
    ``ShardedQTensor`` instead);
  * MoE expert stacks ``[G, E, din, dout]`` -> a ``[G][E]`` nested list
    of QTensors (the JAX walk stacks a plain QTensor's fields over
    ``[G, E]``);
  * unstacked 2-D projections (``lm_head``) -> one QTensor;
  * everything else (norms, embeddings, biases, small or non-tileable
    leaves) stays dense.

``build_exec_weights(params)`` is the serving **weight plan**: every
stream leaf dequantized once into a dense fp32 tensor of its logical shape,
so the step multiplies dense weights (a ``[G][E]`` expert list becomes
one ``[G, E, din, dout]`` tensor, multiplied by ``torch.bmm``). The port's engine keeps it as a
switch (``weight_plan``), off by default: the streams go through the qmm
kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.apply import is_quantizable
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import (QTensor, dequantize_qtensor,
                                      quantize_qtensor)


def _tileable(din: int, dout: int, cfg: QMCConfig) -> bool:
    r, c = cfg.subtile
    return din >= r and dout >= c and din % r == 0 and dout % c == 0


def _convert_leaf(leaf: torch.Tensor, cfg: QMCConfig):
    din, dout = leaf.shape[-2:]
    if not _tileable(din, dout, cfg):
        return leaf

    def convert(w):
        if w.ndim == 2:
            return quantize_qtensor(w, cfg)
        return [convert(w[i]) for i in range(w.shape[0])]
    return convert(leaf)


def quantize_for_serving(params, qmc: QMCConfig, min_dim: int = 128):
    """Convert a parameter tree (nested dicts of tensors) to the serving
    format; quantization runs on the device the leaves lie on."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        if is_quantizable(path, tree, min_dim):
            return _convert_leaf(tree, qmc)
        return tree
    return walk(params, "")


def is_stream_leaf(leaf) -> bool:
    """A QTensor, or a (nested) per-group / per-expert list of them."""
    return isinstance(leaf, QTensor) or (
        isinstance(leaf, list) and bool(leaf) and is_stream_leaf(leaf[0]))


def build_exec_weights(params, dtype=torch.float32):
    """Lower every stream leaf to a dense ``dtype`` tensor (stacked [G]
    lists become one [G, din, dout] tensor, [G][E] lists one [G, E, din,
    dout]); dense leaves pass through."""
    def lower(tree):
        if isinstance(tree, dict):
            return {k: lower(v) for k, v in tree.items()}
        if isinstance(tree, QTensor):
            return dequantize_qtensor(tree, dtype)
        if is_stream_leaf(tree):
            return torch.stack([lower(q) for q in tree])
        return tree
    return lower(params)
