"""Int8 gradient compression with error feedback (counterpart of
``repro.optim.grad_compress``).

Gradients are quantized to int8 per chunk of ``CHUNK`` elements (the
flattened leaf zero-padded to a whole chunk; scale = max|chunk| / 127 +
1e-12, codes rounded half to even and clipped to [-127, 127]) and
dequantized after the wire; the quantization's residual is carried into
the next step's gradient (error feedback). ``torch.round`` and
``jnp.round`` both round half to even, so codes, scales and residuals
equal the reference's exactly.

The reference's docstring says its trainer uses it on a mesh with a
``pod`` axis; its trainer never calls it, and neither does the port's:
the port keeps the pair, held to the reference, and wires it nowhere
(ROADMAP C, "Reference quirks").
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as T

CHUNK = 2048


def _quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1)
    pad = (-flat.numel()) % CHUNK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(-1, CHUNK)
    scale = chunks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(chunks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                     shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compress(grads: Any, err: Any) -> Tuple[Any, Any]:
    """grads + error feedback -> (a tree of ``{"q", "scale"}``, the new
    error tree)."""
    qs, es = [], []
    for g, e in zip(T.leaves(grads), T.leaves(err)):
        g32 = g.to(torch.float32) + e
        q, s = _quantize_int8(g32)
        qs.append({"q": q, "scale": s})
        es.append(g32 - _dequantize_int8(q, s, g.shape))
    return T.unflatten(grads, qs), T.unflatten(grads, es)


def decompress(qtree: Any, shapes: Any) -> Any:
    """The dequantized tree, each leaf in the shape and dtype of its
    counterpart in ``shapes`` (the structure ``qtree`` came from)."""
    refs = T.leaves(shapes)
    return T.unflatten(shapes, [
        _dequantize_int8(q["q"], q["scale"], r.shape).to(r.dtype)
        for q, r in zip(_compressed(qtree), refs)])


def _compressed(t) -> list:
    """The ``{"q", "scale"}`` leaves of a compressed tree, in
    ``tree.items`` order."""
    if isinstance(t, dict) and set(t) == {"q", "scale"}:
        return [t]
    if isinstance(t, dict):
        return [c for k in sorted(t) for c in _compressed(t[k])]
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return [c for f in t._fields for c in _compressed(getattr(t, f))]
    return [c for v in t for c in _compressed(v)]


def init_error(params) -> Any:
    return T.map_(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device), params)
