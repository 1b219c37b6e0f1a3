"""Wrappers of the dual-stream qmm kernels (``csrc/qmm.cu``).

``qmm_decode`` (decode widths, M % 8 == 0) and ``qmm_colstrip`` (M % 128
== 0) replace ``repro.kernels.qmm.qmm_pallas`` and ``qmm_pallas_colstrip``.
On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs the plain version (``kernels.ref.qmm_ref``). ``kernels.ops.qmm``
picks between them and pads M.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import build
from repro_torch.kernels.ref import qmm_ref

# blocks in flight a K split aims for (2 per SM of an H100)
_TARGET_BLOCKS = 264
# subtile rows a decode block may take: its x slice, 8 rows of 8 * 256
# fp32 values, is 64 KB of shared memory beside a 32 KB ring, so two
# blocks still fit an SM
DECODE_MAX_ROWS = 256


def decode_splits(m: int, k: int, n: int) -> Tuple[int, int]:
    """(K splits, subtile rows per split) of the decode-width kernel: its
    (N/128) strips x (M/8) tiles split over K up to about
    ``_TARGET_BLOCKS`` blocks, >= 8 and <= ``DECODE_MAX_ROWS`` subtile rows
    each."""
    tiles = (n // 128) * (m // 8)
    gr = k // 8
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles), gr // 8),
                 -(-gr // DECODE_MAX_ROWS))
    per = -(-gr // splits)
    return -(-gr // per), per


COLSTRIP_BM = 64   # rows of the column-strip kernel's output tile
_SPLIT_SLACK = 1.05   # modeled cost a column-strip plan may trade for
                      # fewer K splits


def colstrip_splits(m: int, k: int, n: int) -> Tuple[int, int]:
    """(K splits, K rows per split) of the column-strip kernel: its
    (N/128) x (M/64) output tiles split over K in 32-row steps, >= 8 steps
    (256 rows) each. The cost of a split is its rounds of
    ``_TARGET_BLOCKS`` resident blocks times K steps per block; the fewest
    splits within ``_SPLIT_SLACK`` of the least cost are taken, since each
    split adds an M x N fp32 partial to write and sum."""
    tiles = (n // 128) * (m // COLSTRIP_BM)
    steps = k // 32
    plans = {}
    for want in range(1, max(1, steps // 8) + 1):
        per = -(-steps // want)
        splits = -(-steps // per)
        plans[splits] = (-(-tiles * splits // _TARGET_BLOCKS) * per, per)
    least = min(cost for cost, _ in plans.values())
    splits = min(s for s, (cost, _) in plans.items()
                 if cost <= _SPLIT_SLACK * least)
    return splits, plans[splits][1] * 32


def _check(x: torch.Tensor, qt: QTensor, m_multiple: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned [M, K] "
                         "tensor")
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


# the decode kernel's split tickets: one zeroed int32 per (strip, M tile),
# per (device, stream); the kernel leaves them zeroed
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def decode_counters(device: torch.device, stream: int,
                    need: int) -> torch.Tensor:
    """The cached ticket buffer of ``(device, stream)``, at least ``need``
    counters long (a larger grid replaces it by a larger zeroed one)."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def qmm_decode(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x [M, K] @ dequant(qt) via the decode-width kernel (M % 8 == 0),
    one launch whatever the K split."""
    if x.device.type == "cpu":
        return qmm_ref(x, qt)
    _check(x, qt, 8)
    m, k = x.shape
    n = qt.shape[1]
    splits, rows = decode_splits(m, k, n)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partial = counters = None
        if splits > 1:
            partial = torch.empty((splits, m, n), dtype=torch.float32,
                                  device=x.device)
            counters = decode_counters(x.device, stream,
                                       (n // 128) * (m // 8))
        rc = lib.qmc_qmm_decode(
            *_operands(x, qt),
            partial.data_ptr() if partial is not None else None,
            counters.data_ptr() if counters is not None else None,
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


def empty_launch() -> None:
    """Launch an empty kernel on the current stream of the current device:
    the floor under the device time of any one-launch call. Not a kernel
    of the port, so it counts no launch."""
    lib = build.library()
    rc = lib.qmc_empty(torch.cuda.current_stream().cuda_stream)
    build.check(rc, "empty kernel")
