"""Page-granular KV stream accounting (the two rules of
``repro.memsys.workload`` the serving engine uses)."""
from __future__ import annotations


def pages_for(n_tokens: int, page: int) -> int:
    """Pages needed to hold n_tokens (ceil division, min 1)."""
    return max(1, -(-int(n_tokens) // page))


def chunk_pages_streamed(q_start: int, n_new: int, *, page: int = 16,
                         q_block: int = 16) -> int:
    """Live pages the ragged paged-attention kernel streams for one chunk
    of ``n_new`` query tokens at ``q_start``: q block ``qb`` reads the
    pages causally visible to it, ``p * page < min(q_start + n_new,
    q_start + (qb+1) * q_block)`` — the kernel's loop bound."""
    q_start, n_new = int(q_start), int(n_new)
    if n_new <= 0:
        return 0
    kv_len = q_start + n_new
    total = 0
    for qb in range(-(-n_new // q_block)):
        limit = min(kv_len, q_start + (qb + 1) * q_block)
        total += -(-limit // page)
    return total
