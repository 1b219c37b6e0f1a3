"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Every source is compiled by ``nvcc`` for ``sm_90a`` into an object — one
``nvcc`` per source, all started together — and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds, not the
minutes ``torch.utils.cpp_extension.load`` needs.

The library goes under ``build/kernels/<hash>/`` at the repository root
(git-ignored), keyed by a hash of the sources and flags, so the first
call in a fresh checkout builds it and later calls load it. The build
uses only the sources in the repository.

``launches`` counts kernel launches per kernel: each wrapper adds one
where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "libqmc_kernels.so"

KERNELS = ("qmm_decode", "qmm_colstrip", "ragged_paged_attention",
           "unpack3b")
launches: Dict[str, int] = {k: 0 for k in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "qmc_qmm_decode": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _P],
    "qmc_qmm_colstrip": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P],
    "qmc_ragged_paged_attention": [_P] * 14 + [_I] * 9 + [_F, _F]
                                  + [_I] * 6 + [_P],
    "qmc_ragged_paged_attention_smem": [_I] * 6,
    "qmc_ragged_paged_attention_route": [_I] * 3,
    "qmc_unpack3b": [_P, _P, _L, _P],
    "qmc_empty": [_P],
}

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}   # seconds, path, compiler output


def count_launch(name: str) -> None:
    launches[name] += 1


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Build the kernel library if this source hash has none yet; return
    its path. Compiler output (with ``-Xptxas -v`` register and shared
    memory reports) lands in ``build_info["log"]``, each unit's compile
    seconds in ``build_info["unit_seconds"]``."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_info.update(path=str(lib), seconds=0.0, log="(cached)")
        return lib
    nvcc = _nvcc()
    tmp = out_dir / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    units = [s for s in _sources() if s.suffix == ".cu"]
    objs = [tmp / (s.stem + ".o") for s in units]
    outs = [tmp / (s.stem + ".log") for s in units]
    procs = []
    for src, obj, out in zip(units, objs, outs):
        with open(out, "w") as f:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
                 str(obj)], stdout=f, stderr=subprocess.STDOUT))
    # each unit's wall seconds, to the 50 ms poll
    unit_seconds: Dict[str, float] = {}
    while len(unit_seconds) < len(units):
        for src, p in zip(units, procs):
            if src.name not in unit_seconds and p.poll() is not None:
                unit_seconds[src.name] = time.monotonic() - t0
        time.sleep(0.05)
    logs = []
    failed = []
    for src, p, out in zip(units, procs, outs):
        logs.append(f"== {src.name} ({unit_seconds[src.name]:.1f} s)\n"
                    f"{out.read_text()}")
        if p.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
         str(tmp / LIB_NAME)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp / LIB_NAME, lib)
    shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(path=str(lib), seconds=time.monotonic() - t0,
                      unit_seconds=unit_seconds, log="\n".join(logs))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.qmc_error_string.argtypes = [ctypes.c_int]
        lib.qmc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = library().qmc_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
