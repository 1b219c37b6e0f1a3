"""Atomic, async checkpoints of the port's trees (counterpart of
``repro.checkpoint.ckpt``), stored with numpy and the standard library.

Layout:  <dir>/step_<N>/
           index.json      — leaf paths, shapes, dtypes, shard, step
           shard_<i>.npz   — leaf arrays, chunked ~512 MB per file
         <dir>/LATEST      — atomic pointer (written last)

A step directory is written under ``step_<N>.tmp`` and renamed into place,
then ``LATEST`` is replaced: a reader sees a whole checkpoint or the one
before it. bf16 leaves travel as their 16-bit patterns (numpy has no
bf16) and come back bit for bit. ``restore`` loads into the structure,
dtypes and devices of a tree like the saved one and refuses a leaf whose
shape differs. Leaves are saved whole (on a mesh, gathered first:
``launch.sharding.unshard``), so a checkpoint restores onto any mesh:
``restore(..., slice_fn=)`` gives each leaf this rank's slice of the
whole array on disk (the reference's ``restore(..., shardings=)``, the
elastic-restart path; ``launch.sharding.restore_slicer`` makes one).

Async: ``AsyncCheckpointer.save`` snapshots to host memory synchronously
and writes in a daemon thread so training continues during the I/O.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T

_MAX_SHARD_BYTES = 512 * 1024 * 1024


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A snapshot of ``leaf`` as numpy (bf16 as its uint16 bits) and its
    dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _snapshot(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: _to_host(v) for k, v in T.items(tree)}


def save(tree, directory: str, step: int) -> str:
    return _write(_snapshot(tree), directory, step)


def _write(host: Dict[str, Tuple[np.ndarray, str]], directory: str,
           step: int) -> str:
    stepdir = os.path.join(directory, f"step_{step}")
    tmpdir = stepdir + ".tmp"
    os.makedirs(tmpdir, exist_ok=True)

    index = {"step": step, "leaves": {}, "shards": 0}
    shard: Dict[str, np.ndarray] = {}
    size = 0
    shard_id = 0

    def flush():
        nonlocal shard, size, shard_id
        if not shard:
            return
        np.savez(os.path.join(tmpdir, f"shard_{shard_id}.npz"), **shard)
        shard, size = {}, 0
        shard_id += 1

    for i, (key, (arr, dtype)) in enumerate(sorted(host.items())):
        if size + arr.nbytes > _MAX_SHARD_BYTES and shard:
            flush()
        name = f"leaf_{i}"
        shard[name] = arr
        index["leaves"][key] = {"shard": shard_id, "name": name,
                                "dtype": dtype, "shape": list(arr.shape)}
        size += arr.nbytes
    flush()
    index["shards"] = shard_id
    with open(os.path.join(tmpdir, "index.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(stepdir):
        shutil.rmtree(stepdir)
    os.rename(tmpdir, stepdir)                    # atomic publish
    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return stepdir


class AsyncCheckpointer:
    """Snapshot-on-call, write-in-background. One outstanding write."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, tree, directory: str, step: int):
        self.wait()
        host = _snapshot(tree)

        def run():
            self.last_path = _write(host, directory, step)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore(tree_like, directory: str, step: Optional[int] = None, *,
            slice_fn: Optional[Callable] = None):
    """Load into the structure of ``tree_like`` (shapes must match; each
    leaf takes its counterpart's dtype and device). Returns ``(tree,
    step)``. With ``slice_fn``, ``tree_like`` holds this rank's slices
    and each leaf on disk becomes ``slice_fn(path, whole array)``, the
    rank's block of it, before the shape check."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    stepdir = os.path.join(directory, f"step_{step}")
    with open(os.path.join(stepdir, "index.json")) as f:
        index = json.load(f)

    shards: Dict[int, np.lib.npyio.NpzFile] = {}
    try:
        out = []
        for key, ref in T.items(tree_like):
            meta = index["leaves"][key]
            sid = meta["shard"]
            if sid not in shards:
                shards[sid] = np.load(os.path.join(stepdir,
                                                   f"shard_{sid}.npz"))
            arr = shards[sid][meta["name"]]
            if slice_fn is not None:
                arr = slice_fn(key, arr)
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(ref.shape)}")
            arr = np.asarray(arr, order="C")       # a slice: contiguous
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out.append(t.to(device=ref.device, dtype=ref.dtype))
    finally:
        for z in shards.values():
            z.close()
    return T.unflatten(tree_like, out), step
