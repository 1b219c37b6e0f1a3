"""The benchmark's CPU tests import the port from ``src/``; tests that
need a CUDA card carry the ``gpu`` marker and skip without one. Each
pytest worker runs torch on one thread: several workers with a thread
per core each oversubscribe the cores many times over."""
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

_SRC = str(Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the PyTorch port's hand-written "
        "kernels); skips without one")
