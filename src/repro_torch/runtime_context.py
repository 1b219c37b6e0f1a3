"""The active mesh of the serving step (counterpart of
``repro.runtime_context``).

The mesh step set enters ``use_mesh`` around each step; the model code
reads it where a matmul dispatches (``models.layers.matmul_any``) and
where attention reads the arena. ``page_slice`` is the port's addition:
the ``(first page, pages)`` of the global arena this rank holds, which
JAX's shard-local attention takes as ``meta`` inside ``shard_map``.
``split_rows`` is another: whether the rows of the batch are split over
the dp axes (each dp rank holds its rows of the global batch: the
training step, the serving step and the contiguous calls where the batch
divides the dp axes, as JAX's ``batch_spec`` has it; an MoE block's
capacity, drops and load-balancing loss are then taken over every dp
rank's rows, and qmm plans its route on the global row count) or every
dp rank runs every row; ``current_row_axes`` names the axes the rows are
split over and ``current_row_split`` how many ranks share them. Under a
split serving step ``lanes`` holds every lane's ``(positions [B, C],
valid_len [B])``, which attention reads: it runs every lane over the
rank's page slice. ``seq_slice`` ``(first, n, total)`` says that the
contiguous cache holds positions ``[first, first + n)`` of ``total`` (the
sequence cut over ``data`` where the batch does not divide the dp axes).
Off a mesh everything reads ``None``, ``()`` or 1.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

_MESH = None
_DP: Tuple[str, ...] = ()
_PAGES: Optional[Tuple[int, int]] = None
_SPLIT = False
_LANES: Optional[tuple] = None
_SEQ: Optional[Tuple[int, int, int]] = None


@contextlib.contextmanager
def use_mesh(mesh, dp: Tuple[str, ...] = (),
             page_slice: Optional[Tuple[int, int]] = None,
             split_rows: bool = False, lanes: Optional[tuple] = None,
             seq_slice: Optional[Tuple[int, int, int]] = None):
    global _MESH, _DP, _PAGES, _SPLIT, _LANES, _SEQ
    prev = _MESH, _DP, _PAGES, _SPLIT, _LANES, _SEQ
    _MESH, _DP, _PAGES, _SPLIT = mesh, tuple(dp), page_slice, split_rows
    _LANES, _SEQ = lanes, seq_slice
    try:
        yield
    finally:
        _MESH, _DP, _PAGES, _SPLIT, _LANES, _SEQ = prev


def current_mesh():
    return _MESH


def current_dp() -> Tuple[str, ...]:
    return _DP


def current_row_axes() -> Tuple[str, ...]:
    """The dp axes the batch's rows are split over (``()`` where every
    rank runs every row)."""
    return _DP if _SPLIT else ()


def current_row_split() -> int:
    """How many ranks share the batch's rows (1 off a split): the product
    of the sizes of ``current_row_axes``."""
    n = 1
    for ax in current_row_axes():
        n *= int(_MESH.devices.shape[list(_MESH.axis_names).index(ax)])
    return n


def current_page_slice() -> Optional[Tuple[int, int]]:
    return _PAGES


def current_lanes() -> Optional[tuple]:
    """Every lane's ``(positions, valid_len)`` under a split serving step
    (None elsewhere)."""
    return _LANES


def current_seq_slice() -> Optional[Tuple[int, int, int]]:
    """``(first, n, total)`` of the rank's sequence cut of a contiguous
    cache (None where it holds every position)."""
    return _SEQ
