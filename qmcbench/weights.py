"""Dense fp32 weights from the run's seed, made on the device with one
``torch.Generator`` and one call per stacked leaf, in the layout the port
reads (``repro_torch.models.model.init_params``: block leaves stacked
``[G, ...]`` over layer groups, ``[din, dout]`` projections). The scales
are the port's; norm scales, q/k/v biases, SSM decay rates and skip
weights are random too, so that every path of the block carries numbers.

The benchmark hands these same tensors to the program, which quantizes
them itself, and makes them again from the seed for the reference, which
quantizes them with its own copy of QMC. Both sides read nothing else."""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch


def _leaves(m: dict) -> Iterator[Tuple[str, tuple, str, float]]:
    """(path, shape, law, scale) of every leaf, in generation order: law
    ``normal`` is ``scale * N(0, 1)``, ``one_normal`` ``1 + scale * N(0,
    1)``, ``a_log`` ``log U(1, 16)``, ``dt_bias`` the inverse softplus of
    a log-uniform dt in [1e-3, 1e-1]."""
    d, v, nl = m["d_model"], m["vocab"], m["n_layers"]
    pattern = m["pattern"]
    g = nl // len(pattern)
    hd = m["head_dim"]
    att, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    yield "embed/tok", (v, d), "normal", 0.02
    yield "final_norm", (d,), "normal", 0.1
    if not m.get("tie_embeddings"):
        yield "lm_head", (d, v), "normal", d ** -0.5
    for i, kind in enumerate(pattern):
        b = f"blocks/b{i}"
        yield f"{b}/norm1", (g, d), "normal", 0.1
        if kind.startswith(("attn", "hybrid")):
            yield f"{b}/attn/wq", (g, d, att), "normal", d ** -0.5
            yield f"{b}/attn/wk", (g, d, kv), "normal", d ** -0.5
            yield f"{b}/attn/wv", (g, d, kv), "normal", d ** -0.5
            yield (f"{b}/attn/wo", (g, att, d), "normal",
                   1.0 / math.sqrt(att * 2 * nl))
            if m.get("qkv_bias"):
                for name, n in (("bq", att), ("bk", kv), ("bv", kv)):
                    yield f"{b}/attn/{name}", (g, n), "normal", 0.02
        if kind == "mamba" or kind.startswith("hybrid"):
            di = m["expand"] * d
            nh = di // m["ssm_headdim"]
            gn = m["ssm_ngroups"] * m["d_state"]
            conv = di + 2 * gn
            yield (f"{b}/mamba/in_proj", (g, d, 2 * di + 2 * gn + nh),
                   "normal", d ** -0.5)
            yield (f"{b}/mamba/conv_w", (g, conv, m["d_conv"]), "normal",
                   m["d_conv"] ** -0.5)
            yield f"{b}/mamba/a_log", (g, nh), "a_log", 0.0
            yield f"{b}/mamba/d_skip", (g, nh), "one_normal", 0.1
            yield f"{b}/mamba/dt_bias", (g, nh), "dt_bias", 0.0
            yield f"{b}/mamba/norm_scale", (g, di), "normal", 0.1
            yield (f"{b}/mamba/out_proj", (g, di, d), "normal",
                   1.0 / math.sqrt(di * 2 * nl))
        if m["d_ff"]:
            ff = m["d_ff"]
            yield f"{b}/norm2", (g, d), "normal", 0.1
            yield f"{b}/ffn/w_up", (g, d, ff), "normal", d ** -0.5
            yield (f"{b}/ffn/w_down", (g, ff, d), "normal",
                   1.0 / math.sqrt(ff * 2 * nl))
            if m.get("gated_mlp", True):
                yield f"{b}/ffn/w_gate", (g, d, ff), "normal", d ** -0.5


def leaf_shapes(model: dict):
    """(path, shape) of every leaf, without making it."""
    return [(path, shape) for path, shape, _, _ in _leaves(model)]


def _draw(gen, shape, law: str, scale: float, device) -> torch.Tensor:
    if law in ("normal", "one_normal"):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        x.mul_(scale)
        if law == "one_normal":
            x.add_(1.0)
        return x
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    if law == "a_log":
        return torch.log(1.0 + 15.0 * u)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return dt + torch.log(-torch.expm1(-dt))


def dense_params(model: dict, seed: int, device) -> Dict:
    """The nested parameter dict of ``model`` (a configuration file's
    ``model`` block) from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: Dict = {}
    for path, shape, law, scale in _leaves(model):
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _draw(gen, shape, law, scale, device)
    return tree


def iter_leaves(tree: dict, prefix: str = ""):
    """(path, tensor) of every leaf of a nested dict."""
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from iter_leaves(v, p)
        else:
            yield p, v
