"""ShardedQTensor — the QMC deployment format for tensor-parallel serving
(counterpart of ``repro.core.qtensor_sharded``).

Production PTQ quantizes each weight *shard* on its own (quantize-after-
shard), so every rank holds the compact streams of its own TP slice and
the qmm kernel runs locally: column-sharded weights give each rank its own
output columns, row-sharded weights give partial sums that one
``all_reduce`` over ``model`` adds. Every field carries a leading shard
dim. A rank holds only its own shard: ``first`` is the index of the first
shard the fields hold (0 and all ``n_shards`` of them in a whole
tensor, the rank's ``m`` and one shard on a rank).

Stream sizes are equal across shards because the subtile top-rho rule
picks exactly ``round(rho * n_sub_shard)`` outlier subtiles per shard.

``shard_qtensor`` cuts the streams of one QTensor along its subtile grid
instead (shard-after-quantize): the slices of the same dequantized weight,
where the cut falls on (8, 128) subtile boundaries. A slice's streams are
as long as its own subtiles need; all slices together are padded to the
longest with zero tiles, which no position points at.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import (QTensor, dequantize_qtensor,
                                      quantize_qtensor)
from repro_torch.kernels import ops as kops

_FIELDS = ("in_codes", "out_codes", "stream_pos", "is_out", "scale_in",
           "scale_out")


@dataclasses.dataclass
class ShardedQTensor:
    in_codes: torch.Tensor      # [S, n_in, 8, 128]
    out_codes: torch.Tensor     # [S, n_out, 8, 128]
    stream_pos: torch.Tensor    # [S, gr, gc]
    is_out: torch.Tensor        # [S, gr, gc]
    scale_in: torch.Tensor      # [S, 1, dout_shard]
    scale_out: torch.Tensor     # [S, 1, dout_shard]
    shape: Tuple[int, int]      # full (unsharded) weight shape
    bits_in: int
    bits_out: int
    subtile: Tuple[int, int]
    shard_axis: int             # 0 = row-sharded (input dim), 1 = column
    n_shards: int
    first: int = 0              # index of the first shard held

    @property
    def ndim(self) -> int:
        return 2

    @property
    def held(self) -> range:
        return range(self.first, self.first + self.in_codes.shape[0])

    @property
    def device(self) -> torch.device:
        return self.scale_in.device

    def local_shape(self) -> Tuple[int, int]:
        shape = list(self.shape)
        shape[self.shard_axis] //= self.n_shards
        return tuple(shape)

    def local(self, i: int) -> QTensor:
        if i not in self.held:
            raise IndexError(f"shard {i} is not held (holds {self.held})")
        j = i - self.first
        return QTensor(*(getattr(self, f)[j] for f in _FIELDS),
                       shape=self.local_shape(), bits_in=self.bits_in,
                       bits_out=self.bits_out, subtile=self.subtile)

    def select(self, i: int) -> "ShardedQTensor":
        """Shard ``i`` alone (what rank ``m = i`` of the model axis
        holds)."""
        j = i - self.first
        if i not in self.held:
            raise IndexError(f"shard {i} is not held (holds {self.held})")
        return dataclasses.replace(
            self, first=i,
            **{f: getattr(self, f)[j:j + 1].contiguous() for f in _FIELDS})

    def to(self, device) -> "ShardedQTensor":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _FIELDS})


def _stack(qts, shape, cfg_bits, subtile, shard_axis, n_shards,
           first) -> ShardedQTensor:
    sizes = {(q.in_codes.shape[0], q.out_codes.shape[0]) for q in qts}
    if len(sizes) != 1:
        raise ValueError("per-shard stream sizes must match")
    return ShardedQTensor(
        *(torch.stack([getattr(q, f) for q in qts]) for f in _FIELDS),
        shape=tuple(shape), bits_in=cfg_bits[0], bits_out=cfg_bits[1],
        subtile=tuple(subtile), shard_axis=shard_axis, n_shards=n_shards,
        first=first)


def quantize_qtensor_sharded(w: torch.Tensor, cfg: QMCConfig,
                             n_shards: int, shard_axis: int = 1,
                             only: Optional[int] = None) -> ShardedQTensor:
    """Quantize each TP shard of W on its own and stack the streams; with
    ``only``, shard ``only`` alone (a rank's own shard)."""
    if w.ndim != 2 or w.shape[shard_axis] % n_shards:
        raise ValueError(f"cannot cut {tuple(w.shape)} into {n_shards} "
                         f"shards along axis {shard_axis}")
    shards = torch.chunk(w, n_shards, dim=shard_axis)
    ids = range(n_shards) if only is None else [only]
    qts = [quantize_qtensor(shards[i].contiguous(), cfg) for i in ids]
    return _stack(qts, w.shape, (cfg.bits_in, cfg.bits_out), cfg.subtile,
                  shard_axis, n_shards, 0 if only is None else only)


def shard_qtensor(qt: QTensor, n_shards: int, shard_axis: int,
                  only: Optional[int] = None) -> Optional[ShardedQTensor]:
    """The streams of ``qt`` cut into ``n_shards`` slices along
    ``shard_axis`` at subtile boundaries (``only``: that slice alone), or
    None where a slice would split a subtile. Each slice dequantizes to
    the same slice of ``qt``'s weight."""
    r, c = qt.subtile
    din, dout = qt.shape
    unit = r if shard_axis == 0 else c
    size = (din, dout)[shard_axis]
    if size % n_shards or (size // n_shards) % unit:
        return None
    n = (size // n_shards) // unit            # grid rows / cols a slice
    tags = qt.is_out.cpu().numpy()
    pos = qt.stream_pos.cpu().numpy()
    dev = qt.in_codes.device
    ids = range(n_shards) if only is None else [only]
    qts = []
    for i in ids:
        cut = (slice(i * n, (i + 1) * n), slice(None)) if shard_axis == 0 \
            else (slice(None), slice(i * n, (i + 1) * n))
        t, p = tags[cut], pos[cut]
        new_pos = np.zeros(t.shape, np.int32)
        streams = []
        for tag, codes in ((False, qt.in_codes), (True, qt.out_codes)):
            sel = (t == tag).reshape(-1)      # grid scan order
            new_pos.reshape(-1)[sel] = np.arange(int(sel.sum()))
            src = torch.as_tensor(p.reshape(-1)[sel].astype(np.int64),
                                  device=dev)
            s = codes[src] if len(src) else torch.zeros(
                (1, r, c), dtype=codes.dtype, device=dev)
            streams.append(s.contiguous())
        col = cut[1] if shard_axis == 1 else slice(None)
        cols = slice(col.start * c, col.stop * c) if shard_axis == 1 \
            else slice(None)
        qts.append(QTensor(
            streams[0], streams[1], torch.as_tensor(new_pos, device=dev),
            qt.is_out[cut].contiguous(),
            qt.scale_in[:, cols].contiguous(),
            qt.scale_out[:, cols].contiguous(),
            shape=(din // n_shards, dout) if shard_axis == 0
            else (din, dout // n_shards),
            bits_in=qt.bits_in, bits_out=qt.bits_out, subtile=qt.subtile))
    if only is None:
        # the cut need not give every slice as many outlier subtiles: pad
        # the streams with zero tiles (no position points at them)
        for name in ("in_codes", "out_codes"):
            k = max(getattr(q, name).shape[0] for q in qts)
            for q in qts:
                t = getattr(q, name)
                setattr(q, name, torch.cat(
                    [t, t.new_zeros((k - t.shape[0],) + t.shape[1:])]))
    return _stack(qts, qt.shape, (qt.bits_in, qt.bits_out), qt.subtile,
                  shard_axis, n_shards, 0 if only is None else only)


def dequantize_sharded(sqt: ShardedQTensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    parts = [dequantize_qtensor(sqt.local(i), dtype)
             for i in range(sqt.n_shards)]
    return torch.cat(parts, dim=sqt.shard_axis)


def qmm_sharded_ref(x: torch.Tensor, sqt: ShardedQTensor,
                    dtype=None) -> torch.Tensor:
    """Oracle: x [..., K] @ dequant(sqt) [K, N] (every shard held)."""
    w = dequantize_sharded(sqt, dtype or x.dtype)
    return torch.matmul(x, w)


def qmm_shard(x: torch.Tensor, sqt: ShardedQTensor, mesh,
              axis: str = "model", use_kernels: bool = True
              ) -> torch.Tensor:
    """The TP-local quantized matmul of this rank (counterpart of
    ``qmm_shard_map``): a column shard runs the rank's qmm (B2 or B3 by
    ``qmm_plan``) into its own ``N / S`` output columns; a row shard runs
    it on the rank's ``K / S`` slice of x (x arrives as that slice), then
    one ``all_reduce`` SUM over ``axis``. Batch rows are the rank's (every
    lane's where the batch does not divide the dp axes)."""
    y = kops.qmm(x, sqt.local(mesh.index(axis)), use_kernels=use_kernels)
    if sqt.shard_axis == 0:
        mesh.all_reduce(y, axis, "sum", kind="tp")
    return y
