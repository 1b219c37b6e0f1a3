"""Wrappers of the dual-stream qmm kernels (``csrc/qmm.cu``).

``qmm_decode`` (decode widths, M % 8 == 0) and ``qmm_colstrip`` (M % 128
== 0) replace ``repro.kernels.qmm.qmm_pallas`` and ``qmm_pallas_colstrip``.
On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs the plain version (``kernels.ref.qmm_ref``). ``kernels.ops.qmm``
picks between them and pads M.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import build
from repro_torch.kernels.ref import qmm_ref

# blocks in flight a K split aims for (2 per SM of an H100)
_TARGET_BLOCKS = 264


def _k_splits(tiles: int, steps: int, min_steps: int) -> Tuple[int, int]:
    """(splits, steps per split) that bring ``tiles`` output tiles up to
    about ``_TARGET_BLOCKS`` blocks, never fewer than ``min_steps`` of the
    ``steps`` K steps per split."""
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles), steps // min_steps))
    per = -(-steps // splits)
    return -(-steps // per), per


def decode_splits(m: int, k: int, n: int) -> Tuple[int, int]:
    """(K splits, subtile rows per split) of the decode-width kernel: its
    (N/128) strips x (M/8) tiles split over K, >= 8 subtile rows each."""
    return _k_splits((n // 128) * (m // 8), k // 8, 8)


def colstrip_splits(m: int, k: int, n: int) -> Tuple[int, int]:
    """(K splits, K rows per split) of the column-strip kernel: its
    (N/128) x (M/128) tiles split over K in 32-row steps, >= 8 steps
    (256 rows) each."""
    splits, steps = _k_splits((n // 128) * (m // 128), k // 32, 8)
    return splits, steps * 32


def _check(x: torch.Tensor, qt: QTensor, m_multiple: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [M, K] tensor")
    m, k = x.shape
    if tuple(qt.subtile) != (8, 128):
        raise ValueError(f"kernel takes (8, 128) subtiles, got {qt.subtile}")
    if k != qt.shape[0] or k % 128 or qt.shape[1] % 128:
        raise ValueError(f"x {tuple(x.shape)} @ W {qt.shape}: K and N must "
                         f"match and be multiples of 128")
    if m % m_multiple:
        raise ValueError(f"M={m} must be a multiple of {m_multiple}")
    gr, gc = k // 8, qt.shape[1] // 128
    want = {"in_codes": (torch.int8, None), "out_codes": (torch.int8, None),
            "stream_pos": (torch.int32, (gr, gc)),
            "is_out": (torch.bool, (gr, gc)),
            "scale_in": (torch.float32, (1, qt.shape[1])),
            "scale_out": (torch.float32, (1, qt.shape[1]))}
    for name, (dtype, shape) in want.items():
        t = getattr(qt, name)
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"qt.{name} must be a contiguous {dtype} "
                             f"tensor on {x.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"qt.{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name in ("in_codes", "out_codes"):
        t = getattr(qt, name)
        if t.ndim != 3 or tuple(t.shape[1:]) != (8, 128) \
                or t.data_ptr() % 16:
            raise ValueError(f"qt.{name} must be a 16-byte aligned "
                             f"[n, 8, 128] stream")


def _operands(x: torch.Tensor, qt: QTensor):
    return (x.data_ptr(), int(x.dtype == torch.bfloat16),
            qt.in_codes.data_ptr(), qt.out_codes.data_ptr(),
            qt.stream_pos.data_ptr(), qt.is_out.data_ptr(),
            qt.scale_in.data_ptr(), qt.scale_out.data_ptr())


def qmm_decode(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x [M, K] @ dequant(qt) via the decode-width kernel (M % 8 == 0)."""
    if x.device.type == "cpu":
        return qmm_ref(x, qt)
    _check(x, qt, 8)
    m, k = x.shape
    n = qt.shape[1]
    splits, rows = decode_splits(m, k, n)
    partial = torch.empty((splits, m, n), dtype=torch.float32,
                          device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.qmc_qmm_decode(*_operands(x, qt), partial.data_ptr(),
                                y.data_ptr(), m, k, n, splits, rows, stream)
    build.check(rc, "qmm_decode")
    build.count_launch("qmm_decode")
    return y


def qmm_colstrip(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x [M, K] @ dequant(qt) via the column-strip kernel (M % 128 == 0)."""
    if x.device.type == "cpu":
        return qmm_ref(x, qt)
    _check(x, qt, 128)
    m, k = x.shape
    n = qt.shape[1]
    splits, rows = colstrip_splits(m, k, n)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.qmc_qmm_colstrip(
            *_operands(x, qt),
            partial.data_ptr() if partial is not None else None,
            y.data_ptr(), m, k, n, splits, rows, stream)
    build.check(rc, "qmm_colstrip")
    build.count_launch("qmm_colstrip")
    return y
