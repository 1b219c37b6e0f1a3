"""PyTorch/CUDA port of the QMC serving system (the JAX package ``repro``
stays the reference).

The port mirrors ``repro``'s module names and imports only ``torch``,
numpy and the standard library. Its hand-written Hopper kernels live in
``csrc/`` and are built at first use (``kernels/build.py``). Entry points
run on the card unless the caller asks for the CPU (``device="cpu"``),
where every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device with no card
    present raises instead of running on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            f"pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
