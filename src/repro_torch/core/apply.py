"""Model-level quantization: walk a parameter tree (nested dicts of
tensors) and quantize the matmul weights with a chosen method
(counterpart of ``repro.core.apply``). This is the public PTQ entry point:

    qparams = quantize_model(params, method="qmc", qmc=QMCConfig(...))

Methods
-------
fp16        identity (baseline)
rtn4        rounding-to-nearest INT4 (per-out-channel abs-max)
mx4         MXINT4 microscaling
qmc         Algorithm 1, scalar granularity (paper-faithful), fake-quant
qmc_subtile Algorithm 1, (8,128)-subtile granularity, fake-quant
qtensor     the dual-stream deployment format: 2-D leaves become QTensors
gptq, awq   not ported yet (they need calibration taps from the forward)

Leaf selection: 2-D (or batched 3-D/4-D, e.g. stacked layers [G, din,
dout]) float leaves with min(last two dims) >= min_dim, excluding
embedding/norm-style parameters by path name. Leaves are visited in
sorted key order, as ``jax.tree_util`` flattens a dict, so draws from a
noise generator fall on the leaves in the reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import torch

from repro_torch.core.mx import mx_fake_quant
from repro_torch.core.qconfig import MXConfig, QMCConfig, RTNConfig
from repro_torch.core.qmc import qmc_fake_quant
from repro_torch.core.qtensor import QTensor, quantize_qtensor
from repro_torch.core.quantizers import rtn_quantize

EXCLUDE_SUBSTRINGS = ("embed", "norm", "scale", "bias", "a_log", "dt_bias",
                      "conv", "d_skip", "pos")
FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
METHODS = ("fp16", "rtn4", "mx4", "qmc", "qmc_subtile", "qtensor")
# the QTensor fields in the reference's pytree order
_QT_FIELDS = ("in_codes", "out_codes", "stream_pos", "is_out", "scale_in",
              "scale_out")


def path_str(path) -> str:
    return "/".join(str(p) for p in path)


def is_quantizable(path: str, leaf, min_dim: int = 64) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    if leaf.ndim < 2 or leaf.ndim > 4:
        return False
    if leaf.dtype not in FLOAT_DTYPES:
        return False
    low = path.lower()
    if any(s in low for s in EXCLUDE_SUBSTRINGS):
        return False
    return min(leaf.shape[-2:]) >= min_dim


def _batched(fn: Callable, leaf: torch.Tensor,
             noise_gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Apply a 2-D quantizer over leading batch dims (stacked layers).

    The reference splits one noise key per leaf and hands that same key
    to every group of a stacked leaf, so every group draws the same
    numbers; here the generator's state is restored before each group."""
    if leaf.ndim == 2:
        return fn(leaf)
    flat = leaf.reshape((-1,) + tuple(leaf.shape[-2:]))
    state = noise_gen.get_state() if noise_gen is not None else None
    out = []
    for i in range(flat.shape[0]):
        if state is not None:
            noise_gen.set_state(state)
        out.append(fn(flat[i]))
    return torch.stack(out).reshape(leaf.shape)


def quantize_model(params, method: str = "qmc",
                   qmc: QMCConfig = QMCConfig(),
                   rtn: RTNConfig = RTNConfig(),
                   mx: MXConfig = MXConfig(),
                   noise_gen: Optional[torch.Generator] = None,
                   noise_aware: bool = True,
                   min_dim: int = 64):
    """Quantize every eligible weight in ``params``; returns a new tree
    (``fp16`` returns ``params`` itself). Quantization runs on the device
    each leaf lies on; ``noise_gen`` (``qmc`` methods only) must be a
    generator on that device."""
    if method in ("gptq", "awq"):
        raise NotImplementedError(
            f"method {method!r} is not ported yet: it needs calibration "
            f"taps from the forward pass (ROADMAP A10)")
    if method not in METHODS:
        raise ValueError(f"unknown method {method}")
    if method == "fp16":
        return params
    cfg = qmc
    if method == "qmc_subtile" and cfg.granularity != "subtile":
        cfg = dataclasses.replace(cfg, granularity="subtile")

    def leaf_fn(path: str, leaf):
        if not is_quantizable(path, leaf, min_dim=min_dim):
            return leaf
        if method == "qtensor":
            r, c = qmc.subtile
            if leaf.ndim == 2 and leaf.shape[0] % r == 0 \
                    and leaf.shape[1] % c == 0:
                return quantize_qtensor(leaf, qmc)
            return leaf            # stacked or non-tileable: stays dense
        if method == "rtn4":
            q = _batched(lambda w: rtn_quantize(w, rtn.bits), leaf)
        elif method == "mx4":
            q = _batched(lambda w: mx_fake_quant(w, mx), leaf)
        else:
            q = _batched(lambda w: qmc_fake_quant(
                w, cfg, noise_gen=noise_gen, noise_aware=noise_aware),
                leaf, noise_gen)
        return q.to(leaf.dtype)

    def walk(tree, path: Tuple[str, ...]):
        if isinstance(tree, dict):
            done = {k: walk(tree[k], path + (k,)) for k in sorted(tree)}
            return {k: done[k] for k in tree}
        return leaf_fn(path_str(path), tree)
    return walk(params, ())


def _leaves(tree, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every array leaf, as ``jax.tree_util`` flattens
    the reference's tree (QTensors into their fields)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif isinstance(tree, QTensor):
        for f in _QT_FIELDS:
            yield path_str(path + (f,)), getattr(tree, f)
    elif isinstance(tree, torch.Tensor):
        yield path_str(path), tree


def model_bits_per_weight(params, method: str, qmc: QMCConfig = QMCConfig(),
                          mx: MXConfig = MXConfig()) -> float:
    """Average logical bits/weight over quantizable leaves (capacity
    view)."""
    n_q = n_total = 0
    for path, leaf in _leaves(params):
        n_total += leaf.numel()
        if is_quantizable(path, leaf):
            n_q += leaf.numel()
    if n_total == 0:
        return 16.0
    bits_q = {"fp16": 16.0, "rtn4": 4.0, "gptq": 4.0, "awq": 4.0,
              "mx4": mx.avg_bits, "qmc": qmc.avg_bits,
              "qmc_subtile": qmc.avg_bits, "qtensor": qmc.avg_bits}[method]
    return (n_q * bits_q + (n_total - n_q) * 16.0) / n_total
