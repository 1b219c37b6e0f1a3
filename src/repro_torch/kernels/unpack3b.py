"""Wrapper of the 3-bit stream decode kernel (``csrc/unpack3b.cu``), the
counterpart of ``repro.kernels.unpack3b.unpack3b_pallas``: the ReRAM read
path, which turns the packed little-endian 3-bit inlier stream that
``core.packing.pack_codes`` writes back into int32 codes.

On a CPU tensor the wrapper runs the plain version
(``kernels.ref.unpack3b_ref``); on a CUDA tensor it launches the kernel,
at any n > 0, or raises. ``kernels.ops.unpack3b`` is this wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import packed_nbytes
from repro_torch.kernels import build
from repro_torch.kernels.ref import unpack3b_ref


def _check(packed: torch.Tensor, n: int) -> None:
    if packed.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {packed.device}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8, got {packed.dtype}")
    if packed.ndim != 1 or not packed.is_contiguous():
        raise ValueError("packed must be a contiguous 1-D byte stream")
    if n <= 0:
        raise ValueError(f"n={n} must be positive")
    if packed.numel() != packed_nbytes(n, 3):
        raise ValueError(f"a stream of {n} 3-bit codes has "
                         f"{packed_nbytes(n, 3)} bytes, got {packed.numel()}")


def unpack3b_call(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Decode ``n`` codes from a ceil(3n/8)-byte uint8 stream."""
    if packed.device.type == "cpu":
        return unpack3b_ref(packed, n)
    _check(packed, n)
    out = torch.empty(n, dtype=torch.int32, device=packed.device)
    lib = build.library()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = lib.qmc_unpack3b(packed.data_ptr(), out.data_ptr(), n, stream)
    build.check(rc, "unpack3b")
    build.count_launch("unpack3b")
    return out
