"""Bit-packing of low-bit codes into dense uint8 streams (counterpart of
``repro.core.packing``).

This is the capacity-accounting layer: logical 3-bit inliers and 5-bit
outliers are packed with zero padding waste (8 codes x 3 bits = 3 bytes;
8 codes x 5 bits = 5 bytes). The same routines model the paper's "bit
packing/unpacking due to the mismatch between 3-bit weight quantization
and 2-bit cell storage" overhead when cell_bits=2.

Codes are signed; they are biased to unsigned before packing. The layout
is little-endian in bit order over the concatenated bitstream, with the
final byte zero-padded. ``pack_codes`` runs in torch ops on the codes'
device; ``unpack_codes`` is the general plain inverse for any ``bits``
(``kernels.ops.unpack3b`` is the 3-bit read path, with a kernel on the
card).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _bias(bits: int) -> int:
    return 2 ** (bits - 1)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed integer codes (any shape) into a flat uint8 stream on
    the codes' device; the bytes equal ``repro.core.packing.pack_codes``'s."""
    flat = codes.reshape(-1).to(torch.int32) + _bias(bits)
    if flat.numel() and (int(flat.min()) < 0 or int(flat.max()) >= 2 ** bits):
        raise ValueError(f"codes out of the {bits}-bit range")
    n = flat.numel()
    nbytes = (n * bits + 7) // 8
    shifts = torch.arange(bits, dtype=torch.int32, device=flat.device)
    stream = ((flat[:, None] >> shifts[None, :]) & 1).to(torch.uint8)
    stream = stream.reshape(-1)
    pad = nbytes * 8 - n * bits
    if pad:
        stream = torch.cat([stream, stream.new_zeros(pad)])
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.int32,
                           device=flat.device)
    return (stream.reshape(nbytes, 8).to(torch.int32) * weights).sum(
        dim=1).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int, n: int,
                 shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Inverse of ``pack_codes``: uint8 stream -> int32 signed codes of
    length ``n`` (reshaped to ``shape`` when given)."""
    byts = packed.to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=byts.device)
    bitstream = (byts[:, None] >> shifts[None, :]) & 1
    bitstream = bitstream.reshape(-1)[: n * bits].reshape(n, bits)
    weights = torch.tensor([1 << i for i in range(bits)], dtype=torch.int32,
                           device=byts.device)
    vals = (bitstream.to(torch.int32) * weights).sum(dim=1).to(
        torch.int32) - _bias(bits)
    if shape is not None:
        vals = vals.reshape(shape)
    return vals


def packed_nbytes(n_codes: int, bits: int) -> int:
    return (n_codes * bits + 7) // 8


def cells_per_weight(logical_bits: int, cell_bits: int) -> float:
    """MLC cells needed to store one logical weight (the paper's 2-bit-mode
    packing mismatch: 3-bit weights in 2-bit cells need 1.5 cells/weight)."""
    return logical_bits / cell_bits
