"""Model-level QMC serving-format conversion (single shard).

``quantize_for_serving(params, qmc)`` converts eligible weight leaves of
a parameter tree into the deployment format, as
``repro.core.serving_quant`` does for ``tp_shards=1``:

  * stacked projections ``[G, din, dout]`` -> a per-group list of
    :class:`QTensor` (the JAX walk stacks the fields of a one-shard
    ``ShardedQTensor`` instead);
  * unstacked 2-D projections (``lm_head``) -> one QTensor;
  * everything else (norms, embeddings, biases, small or non-tileable
    leaves) stays dense.

``build_exec_weights(params)`` is the serving **weight plan**: every
stream leaf dequantized once into a dense fp32 tensor of its logical shape,
so the step multiplies dense weights. The port's engine keeps it as a
switch (``weight_plan``), off by default: the streams go through the qmm
kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import (QTensor, dequantize_qtensor,
                                      quantize_qtensor)

# leaves never quantized, by path substring (repro.core.apply)
EXCLUDE_SUBSTRINGS = ("embed", "norm", "scale", "bias", "a_log", "dt_bias",
                      "conv", "d_skip", "pos")
_FLOAT = (torch.float32, torch.bfloat16, torch.float16)


def _tileable(din: int, dout: int, cfg: QMCConfig) -> bool:
    r, c = cfg.subtile
    return din >= r and dout >= c and din % r == 0 and dout % c == 0


def _convert_leaf(leaf: torch.Tensor, cfg: QMCConfig):
    if leaf.ndim == 4:
        raise NotImplementedError(
            "MoE expert stacks are not ported yet (dense FFNs only)")
    din, dout = leaf.shape[-2:]
    if not _tileable(din, dout, cfg):
        return leaf
    if leaf.ndim == 3:
        return [quantize_qtensor(leaf[g], cfg) for g in range(leaf.shape[0])]
    return quantize_qtensor(leaf, cfg)


def quantize_for_serving(params, qmc: QMCConfig, min_dim: int = 128):
    """Convert a parameter tree (nested dicts of tensors) to the serving
    format; quantization runs on the device the leaves lie on."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        leaf = tree
        shape_ok = (isinstance(leaf, torch.Tensor) and 2 <= leaf.ndim <= 4
                    and min(leaf.shape[-2:]) >= min_dim)
        name_ok = not any(s in path.lower() for s in EXCLUDE_SUBSTRINGS)
        if shape_ok and name_ok and leaf.dtype in _FLOAT:
            return _convert_leaf(leaf, qmc)
        return leaf
    return walk(params, "")


def is_stream_leaf(leaf) -> bool:
    return isinstance(leaf, QTensor) or (
        isinstance(leaf, list) and leaf and isinstance(leaf[0], QTensor))


def build_exec_weights(params, dtype=torch.float32):
    """Lower every stream leaf to a dense ``dtype`` tensor (stacked [G]
    lists become one [G, din, dout] tensor); dense leaves pass through."""
    def lower(tree):
        if isinstance(tree, dict):
            return {k: lower(v) for k, v in tree.items()}
        if isinstance(tree, QTensor):
            return dequantize_qtensor(tree, dtype)
        if is_stream_leaf(tree):
            return torch.stack([dequantize_qtensor(q, dtype) for q in tree])
        return tree
    return lower(params)
