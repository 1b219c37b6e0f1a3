"""Deterministic synthetic language corpus, generated from a seed (a copy
of ``repro.data.synthetic``; numpy only, no data files).

A zipf-mixture Markov language with enough structure to be learnable:
  * K latent "topics", each a sparse bigram table over the vocab;
  * documents pick a topic, tokens follow the topic's bigram chain;
  * a cloze "reasoning" task (benchmarks): the model must recall the
    document's topic-defining token at a distance.

Everything is keyed by (seed, host, step) so multi-host training is
deterministic and restart-safe without any data files.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    vocab: int = 512
    n_topics: int = 8
    branch: int = 24            # out-degree of each bigram node
    seed: int = 1234


class SyntheticCorpus:
    def __init__(self, cfg: CorpusConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, k, b = cfg.vocab, cfg.n_topics, cfg.branch
        # per-topic bigram structure: successor sets + zipf weights
        self.succ = rng.integers(2, v, size=(k, v, b))
        w = 1.0 / np.arange(1, b + 1) ** 1.2
        self.w = w / w.sum()
        self.topic_marker = rng.permutation(v - 2)[:k] + 2  # topic id tokens

    def sample_batch(self, batch: int, seq: int, *, step: int,
                     host: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 4099 + host)
        v, k = self.cfg.vocab, self.cfg.n_topics
        topics = rng.integers(0, k, size=batch)
        toks = np.zeros((batch, seq + 1), np.int32)
        toks[:, 0] = self.topic_marker[topics]
        choice = rng.choice(self.cfg.branch, size=(batch, seq),
                            p=self.w)
        for t in range(seq):
            toks[:, t + 1] = self.succ[topics, toks[:, t], choice[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterate(self, batch: int, seq: int, *, start_step: int = 0,
                host: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.sample_batch(batch, seq, step=step, host=host)
            step += 1

    def heldout_ppl_batches(self, n: int, batch: int, seq: int):
        """Fixed evaluation batches (steps offset far from training)."""
        return [self.sample_batch(batch, seq, step=10_000_000 + i)
                for i in range(n)]

    def cloze_batch(self, n: int, seq: int = 64, *, seed: int = 0):
        """Reasoning probe: predict the topic marker repeated at the end.

        Returns tokens with the final position's correct answer; accuracy =
        P(argmax logits at last position == marker).
        """
        rng = np.random.default_rng(seed + 777)
        b = self.sample_batch(n, seq, step=20_000_000 + seed)
        toks = b["tokens"].copy()
        answers = toks[:, 0].copy()          # the topic marker
        toks[:, -1] = 1                      # cloze query token
        return {"tokens": toks, "answers": answers}
