"""Self-speculative decode: draft proposals and greedy acceptance
(counterpart of ``repro.serve.speculative``; a copy).

The engine's ragged step already compiles C-wide rungs for chunked
prefill (``width_ladder``), so verifying k draft tokens costs one step
call at the smallest rung covering ``1 + k`` — no new compiled shapes,
no second model. The draft here is the cheapest one that works on a
single model: **prompt lookup** (n-gram continuation), the
self-speculative scheme of arXiv:2304.04487 / vLLM's ``[ngram]``
speculator. :func:`propose` finds the most recent earlier occurrence of
the sequence's longest matching suffix n-gram and proposes the tokens
that followed it; :func:`accept_greedy` keeps the verified prefix plus
the model's correction token, which makes speculative greedy decode
token-identical to plain greedy decode at any k (the classic
speculative-decoding guarantee specialized to argmax).

Draft and acceptance are pure host/numpy — only the verify step runs on
device. Rejected draft positions leave garbage K/V behind; that is
masked by ``valid_len`` until real tokens overwrite it, and the pages
allocated for rejected positions are returned via
``PagedKVPool.trim`` (see ``serve/engine.py``).
"""
from __future__ import annotations

import numpy as np


def propose(history: np.ndarray, k: int, max_ngram: int = 3) -> np.ndarray:
    """Prompt-lookup draft: up to ``k`` tokens predicted to follow
    ``history`` (prompt + generated so far, most recent last).

    Tries suffix n-grams from ``max_ngram`` down to 1; on the first n
    with an earlier occurrence, returns the (up to k) tokens that
    followed its most recent earlier occurrence. Empty array when
    nothing matches — the round falls back to plain one-token decode.
    """
    h = np.asarray(history, np.int64).ravel()
    size = int(h.size)
    if size < 2 or k <= 0:
        return np.empty(0, np.int32)
    for n in range(min(max_ngram, size - 1), 0, -1):
        pat = h[size - n:]
        windows = np.lib.stride_tricks.sliding_window_view(h, n)
        starts = np.flatnonzero((windows == pat).all(axis=1))
        starts = starts[starts < size - n]   # exclude the suffix itself
        if starts.size:
            i = int(starts[-1])              # most recent recurrence
            cont = h[i + n: i + n + k]
            if cont.size:
                return cont.astype(np.int32)
    return np.empty(0, np.int32)


def accept_greedy(draft: np.ndarray, selected: np.ndarray) -> int:
    """Tokens to emit from a greedy verify step: the longest draft
    prefix the model agrees with, plus the model's own next token.

    ``selected`` is the step's argmax output for the verify columns
    (``selected[c]`` = the model's token after consuming column c, where
    column 0 carried the last real token and columns 1..k the draft).
    Always >= 1 — even a fully rejected draft yields the token plain
    decode would have produced, so a verify round never loses ground.
    Capped by ``len(selected)``: a caller that truncated the selection
    (e.g. at a budget edge) can never be told to emit past it.
    """
    n = 1
    while (n <= min(len(draft), len(selected))
           and int(draft[n - 1]) == int(selected[n - 1])):
        n += 1
    return min(n, len(selected))
