"""Block-level init/apply: one layer of any supported kind (counterpart
of ``repro.models.blocks``).

A block = pre-norm mixer (attention, the Mamba2 SSD mixer, or both in
parallel, fused as their mean) + residual, then (if the config has an
FFN) pre-norm FFN (dense MLP, or MoE on the config's ``moe_slots``) +
residual.

On a serving mesh each mixer comes back complete on every model rank,
after its own sums over ``model`` (attention's ``wo``, the Mamba2
``out_proj``), so a hybrid block's mean of the two is one process's; the
MoE FFN ends in its one ``moe`` sum (``models.moe``). On a training mesh
the same holds for the gradients: each mixer takes its input through its
own ``tp_input`` (the attention's column-parallel projections; the
Mamba2 ``in_proj``), so the block's ``dx`` is summed over ``model`` once
per mixer, and both mixers' outputs, hence their mean, are whole and
equal on every model rank.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.attention import attn_block
from repro_torch.models.layers import glu_mlp, rms_norm
from repro_torch.models.moe import moe_block
from repro_torch.models.ssm import mamba_block


def _normal(gen, shape, std, device, dtype):
    if gen is None:                   # a "meta" tree: the shapes only
        return torch.empty(shape, device=device, dtype=dtype)
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * std).to(dtype)


def init_attn_params(gen, cfg, g: int, device, dtype=torch.float32) -> dict:
    """Attention weights for ``g`` groups, stacked [g, ...] (the JAX
    layout and scales)."""
    d = cfg.d_model

    def w(din, dout, std=None):
        return _normal(gen, (g, din, dout),
                       std if std is not None else 1.0 / math.sqrt(din),
                       device, dtype)

    p = {"wq": w(d, cfg.attn_dim), "wk": w(d, cfg.kv_dim),
         "wv": w(d, cfg.kv_dim),
         "wo": w(cfg.attn_dim, d,
                 1.0 / math.sqrt(cfg.attn_dim * 2 * cfg.n_layers))}
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.attn_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((g, n), dtype=dtype, device=device)
    return p


def init_mlp_params(gen, cfg, g: int, device, dtype=torch.float32) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w_up": _normal(gen, (g, d, ff), 1.0 / math.sqrt(d), device, dtype),
         "w_down": _normal(gen, (g, ff, d),
                           1.0 / math.sqrt(ff * 2 * cfg.n_layers), device,
                           dtype)}
    if cfg.gated_mlp:
        p["w_gate"] = _normal(gen, (g, d, ff), 1.0 / math.sqrt(d), device,
                              dtype)
    return p


def init_moe_params(gen, cfg, g: int, device, dtype=torch.float32) -> dict:
    """MoE weights for ``g`` groups: a ``[g, d, E]`` fp32 router (std
    0.02) and ``[g, E, d, ff]`` / ``[g, E, ff, d]`` experts, the
    reference's layout and scales."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    std_in = 1.0 / math.sqrt(d)
    p = {"router": _normal(gen, (g, d, e), 0.02, device, torch.float32),
         "w_up": _normal(gen, (g, e, d, ff), std_in, device, dtype),
         "w_down": _normal(gen, (g, e, ff, d),
                           1.0 / math.sqrt(ff * 2 * cfg.n_layers), device,
                           dtype)}
    if cfg.gated_mlp:
        p["w_gate"] = _normal(gen, (g, e, d, ff), std_in, device, dtype)
    return p


def init_mamba_params(gen, cfg, g: int, device, dtype=torch.float32
                      ) -> dict:
    """Mamba2 mixer weights for ``g`` groups, stacked [g, ...], with the
    reference's leaf names, layouts and scales: ``dt_bias`` is the inverse
    softplus of a log-uniform dt in [1e-3, 1e-1]."""
    d, di = cfg.d_model, cfg.d_inner
    nh = cfg.ssm_nheads
    in_dim = 2 * di + 2 * cfg.ssm_ngroups * cfg.d_state + nh
    in_proj = _normal(gen, (g, d, in_dim), 1.0 / math.sqrt(d), device, dtype)
    conv_w = _normal(gen, (g, cfg.conv_dim, cfg.d_conv),
                     1.0 / math.sqrt(cfg.d_conv), device, dtype)
    u = torch.rand((g, nh), generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                   + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))      # inverse softplus
    out_proj = _normal(gen, (g, di, d), 1.0 / math.sqrt(di * 2 * cfg.n_layers),
                       device, dtype)
    a_log = torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                   device=device))
    return {"in_proj": in_proj, "conv_w": conv_w,
            "a_log": a_log.expand(g, nh).clone(),
            "d_skip": torch.ones((g, nh), device=device),
            "dt_bias": dt_bias,
            "norm_scale": torch.zeros((g, di), device=device),
            "out_proj": out_proj}


def _check_kind(kind: str) -> None:
    if not kind.startswith(("attn", "mamba", "hybrid")):
        raise ValueError(kind)


def init_block(gen, kind: str, use_moe: bool, cfg, g: int, device,
               dtype=torch.float32) -> dict:
    _check_kind(kind)
    p = {"norm1": torch.zeros((g, cfg.d_model), device=device)}
    if kind.startswith(("attn", "hybrid")):
        p["attn"] = init_attn_params(gen, cfg, g, device, dtype)
    if kind == "mamba" or kind.startswith("hybrid"):
        p["mamba"] = init_mamba_params(gen, cfg, g, device, dtype)
    if cfg.d_ff > 0:
        p["norm2"] = torch.zeros((g, cfg.d_model), device=device)
        p["ffn"] = (init_moe_params(gen, cfg, g, device, dtype) if use_moe
                    else init_mlp_params(gen, cfg, g, device, dtype))
    return p


def apply_block(p: dict, x: torch.Tensor, kind: str, use_moe: bool, cfg, *,
                positions: torch.Tensor, cache: Optional[dict] = None,
                pos=None, valid_len: Optional[torch.Tensor] = None,
                use_kernels: bool = True,
                paged_attention: bool = False, tap=None,
                aux: Optional[list] = None) -> torch.Tensor:
    """One block, cache-less or over one group's paged or contiguous cache
    (updated in place). A MoE FFN's load-balancing loss is appended to
    ``aux`` when a list is given (the training loss reads it) and dropped
    otherwise, as serving drops it. Attention takes ``valid_len`` as an
    absolute position bound and ``pos`` as the contiguous cache's write
    position of a one-token call; the SSM mixer takes the count of valid
    columns in this window, ``valid_len - positions[:, 0]``. ``tap(name,
    value)`` records the matmul inputs under ``attn/``, ``mamba/``,
    ``ffn/`` or ``moe/``, as the reference's ``_sub`` names them."""
    _check_kind(kind)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    window = cfg.window if kind.endswith("_local") else None
    mixes = []
    if "attn" in p:
        mixes.append(attn_block(
            p["attn"], h, cfg, positions=positions, window=window,
            cache=cache["attn"] if cache is not None else None, pos=pos,
            valid_len=valid_len, use_kernels=use_kernels,
            paged_attention=paged_attention, tap=tap_prefix(tap, "attn")))
    if "mamba" in p:
        ssm_valid = (valid_len - positions[:, 0]
                     if valid_len is not None else None)
        mixes.append(mamba_block(
            p["mamba"], h, cfg,
            cache=cache["mamba"] if cache is not None else None,
            valid_len=ssm_valid, use_kernels=use_kernels,
            tap=tap_prefix(tap, "mamba")))
    x = x + (mixes[0] if len(mixes) == 1 else 0.5 * (mixes[0] + mixes[1]))
    if "ffn" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if use_moe:
            y, a = moe_block(p["ffn"], h, cfg, use_kernels=use_kernels,
                             tap=tap_prefix(tap, "moe"))
            if aux is not None:
                aux.append(a)
        else:
            y = glu_mlp(h, p["ffn"], cfg.act, cfg.gated_mlp,
                        use_kernels=use_kernels, tap=tap_prefix(tap, "ffn"),
                        d_ff=cfg.d_ff)
        x = x + y
    return x


def tap_prefix(tap, prefix: str):
    """``tap`` with ``prefix/`` before every name (None stays None)."""
    if tap is None:
        return None

    def inner(name, value):
        tap(f"{prefix}/{name}", value)
    return inner
