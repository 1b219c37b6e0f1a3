"""The active mesh of the serving step (counterpart of
``repro.runtime_context``).

The mesh step set enters ``use_mesh`` around each step; the model code
reads it where a matmul dispatches (``models.layers.matmul_any``) and
where attention reads the arena. ``page_slice`` is the port's addition:
the ``(first page, pages)`` of the global arena this rank holds, which
JAX's shard-local attention takes as ``meta`` inside ``shard_map``. Off
a mesh everything reads ``None``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

_MESH = None
_DP: Tuple[str, ...] = ()
_PAGES: Optional[Tuple[int, int]] = None


@contextlib.contextmanager
def use_mesh(mesh, dp: Tuple[str, ...] = (),
             page_slice: Optional[Tuple[int, int]] = None):
    global _MESH, _DP, _PAGES
    prev = _MESH, _DP, _PAGES
    _MESH, _DP, _PAGES = mesh, tuple(dp), page_slice
    try:
        yield
    finally:
        _MESH, _DP, _PAGES = prev


def current_mesh():
    return _MESH


def current_dp() -> Tuple[str, ...]:
    return _DP


def current_page_slice() -> Optional[Tuple[int, int]]:
    return _PAGES
