"""The active mesh of the serving step (counterpart of
``repro.runtime_context``).

The mesh step set enters ``use_mesh`` around each step; the model code
reads it where a matmul dispatches (``models.layers.matmul_any``) and
where attention reads the arena. ``page_slice`` is the port's addition:
the ``(first page, pages)`` of the global arena this rank holds, which
JAX's shard-local attention takes as ``meta`` inside ``shard_map``.
``split_rows`` is another: whether the rows of the batch are split over
the dp axes (the training step: each dp rank holds its rows of the global
batch, so the MoE block's capacity, drops and load-balancing loss are
taken over every dp rank's rows) or every dp rank runs every row
(serving); ``current_row_axes`` names the axes the rows are split over.
Off a mesh everything reads ``None`` or ``()``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

_MESH = None
_DP: Tuple[str, ...] = ()
_PAGES: Optional[Tuple[int, int]] = None
_SPLIT = False


@contextlib.contextmanager
def use_mesh(mesh, dp: Tuple[str, ...] = (),
             page_slice: Optional[Tuple[int, int]] = None,
             split_rows: bool = False):
    global _MESH, _DP, _PAGES, _SPLIT
    prev = _MESH, _DP, _PAGES, _SPLIT
    _MESH, _DP, _PAGES, _SPLIT = mesh, tuple(dp), page_slice, split_rows
    try:
        yield
    finally:
        _MESH, _DP, _PAGES, _SPLIT = prev


def current_mesh():
    return _MESH


def current_dp() -> Tuple[str, ...]:
    return _DP


def current_row_axes() -> Tuple[str, ...]:
    """The dp axes the batch's rows are split over (``()`` in serving)."""
    return _DP if _SPLIT else ()


def current_page_slice() -> Optional[Tuple[int, int]]:
    return _PAGES
