"""The paged serving step and its page maintenance (counterpart of the
unified ragged step of ``repro.serve.steps``). Plain functions: PyTorch
runs eagerly, so there is no jit to build or cache.

  ``step(cfg, params, tokens [B, C], arena, start [B], n_new [B], temp
  [B]) -> (tokens [B, C] int32, logprobs [B, C] float32)``

Lane ``b`` runs ``n_new[b]`` new tokens at absolute positions ``start[b]
+ t``: a decode lane carries one token, a prefill lane a chunk of its
prompt, an idle lane ``n_new = 0`` (its writes route to the null page and
its output columns are dead). K/V scatter into the arena (in place) and
the ragged attention read happen in the one call; token selection
(``serve.sampling.select_tokens``) runs on the card, so only ``[B, C]``
ids and logprobs leave it.

``apply_page_ops`` is a round's page maintenance in one call: the
block-table upload into every group (the JAX version also copies pages
for the prefix cache's copy-on-write, which the port does not have yet).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward
from repro_torch.serve.sampling import select_tokens
from repro_torch.serve.scheduler import bucket_len


def width_ladder(chunk: int) -> tuple:
    """Step widths ``C > 1``: pow2 rungs from 4 up to ``chunk``. A short
    prefill chunk runs at the smallest rung that covers it."""
    if chunk <= 1:
        return ()
    w, out = 4, []
    while w < chunk:
        out.append(w)
        w *= 2
    out.append(chunk)
    return tuple(out)


def default_chunk(max_pages_per_seq: int, page: int) -> int:
    """Default prefill chunk width: the pow2 that covers the longest
    admissible sequence (every prompt is one chunk)."""
    return bucket_len(max_pages_per_seq * page, page)


def default_n_pages(slots: int, max_pages_per_seq: int) -> int:
    """Default pool size: every slot at full length (single device)."""
    return slots * max_pages_per_seq


def step(cfg: ModelConfig, params: dict, tokens: torch.Tensor, arena: dict,
         start: torch.Tensor, n_new: torch.Tensor, temp: torch.Tensor, *,
         use_kernels: bool = True, paged_attention: bool = True):
    """The ONE serving step: ragged chunked prefill + batched decode."""
    c = tokens.shape[1]
    positions = start[:, None] + torch.arange(
        c, dtype=start.dtype, device=start.device)[None, :]
    valid = start + n_new
    logits = forward(cfg, params, tokens, positions=positions, cache=arena,
                     valid_len=valid, use_kernels=use_kernels,
                     paged_attention=paged_attention)
    return select_tokens(logits, temp, n_new)


def apply_page_ops(arena: dict, tables: torch.Tensor) -> dict:
    """One round's page maintenance, in place: ``tables [S, P]`` is
    written into every group's ``block_tbl``."""
    for grp in arena.values():
        tbl = grp["attn"]["block_tbl"]
        tbl.copy_(tables.to(torch.int32)[None].expand_as(tbl))
    return arena
