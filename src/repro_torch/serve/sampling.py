"""Token selection inside the serving step (counterpart of
``repro.serve.sampling``).

Greedy lanes (``temperature <= 0``) take ``argmax(logits)`` — the first
maximal index, as ``jnp.argmax`` — and every lane reports the model's
log-softmax at the selected token. Columns at or past ``n_new[b]`` (idle
lanes, right padding) return :data:`DEAD_TOKEN` = -1, an id no vocab
contains.

Sampled lanes (``temperature > 0``) raise ``NotImplementedError`` in this
port: the JAX head draws with threefry keys folded from (seed, uid,
position), which torch cannot reproduce; a threefry port or a
distribution-level test decides the matter later.
"""
from __future__ import annotations

import dataclasses

import torch

DEAD_TOKEN = -1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request token-selection policy (greedy by default)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    logprobs: bool = False

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


GREEDY = SamplingParams()


def select_tokens(logits: torch.Tensor, temp: torch.Tensor,
                  n_new: torch.Tensor):
    """``logits [B, C, V]``, ``temp [B]``, ``n_new [B]`` -> ``(tokens
    [B, C] int32, logprobs [B, C] float32)`` with dead columns at
    :data:`DEAD_TOKEN` / 0.0."""
    if bool((temp > 0).any()):
        raise NotImplementedError(
            "sampled lanes (temperature > 0) are not ported yet: the JAX "
            "head draws with threefry, which torch does not reproduce")
    tok = torch.argmax(logits, dim=-1)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    logp = torch.gather(logp, -1, tok[..., None])[..., 0]
    cols = torch.arange(tok.shape[1], device=tok.device)[None, :]
    live = cols < n_new[:, None].to(tok.device)
    return (torch.where(live, tok, torch.full_like(tok, DEAD_TOKEN))
            .to(torch.int32),
            torch.where(live, logp, torch.zeros_like(logp)))
