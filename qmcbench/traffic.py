"""The one traffic generator: a mix file's parameters and the run's seed
give each wave's requests.

Lengths follow a lognormal of the mix's median and sigma, clipped to its
range. So that every seed asks for the same work, a wave's lengths are
not drawn at random: they are the distribution's quantiles at ``(i +
0.5) / wave`` for ``i < wave``, the same set in every wave and every
run. Which prompt length goes with which output, and the order in which
the requests arrive, are a uniformly random permutation drawn once from
a fixed key (``ORDER_KEY``), not from the seed: the engine seats
requests in list order, so the order sets how long a wave drains behind
a late long request, and an order drawn per seed moved a run's output
rate by 6-7% from seed to seed. Wave ``k`` sends that order rotated by
``floor(frac(k * g) * wave)`` places, ``g`` the golden ratio's
fraction, so that over a run's waves each request's place in the queue
is spread evenly; a mix with ``"rotate": false`` sends the one order in
every wave, so that every wave does the same work (for a mix whose run
holds few waves of unequal length, whether the last one fits in the
window would move the run's rate). No length decides an order. The seed, with the wave's
index, draws the prompts' token ids. Every request is greedy and has no
EOS, so it emits exactly its output length."""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


@dataclasses.dataclass
class Draw:
    uid: int
    prompt: np.ndarray        # int32 token ids
    max_new: int


def lengths(dist: dict, n: int) -> List[int]:
    """The ``n`` stratified quantiles of ``dist`` (``median``, ``sigma``,
    ``min``, ``max``), rounded and clipped, in ascending order."""
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        x = round(dist["median"] * math.exp(dist["sigma"] * z))
        out.append(int(min(max(x, dist["min"]), dist["max"])))
    return out


GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0
ORDER_KEY = 20240531


def rotation(index: int, n: int) -> int:
    """How many places wave ``index`` rotates the order of ``n``."""
    return int((index * GOLDEN) % 1.0 * n)


def wave(traffic: dict, vocab: int, seed: int, index: int) -> List[Draw]:
    """Wave ``index`` of a run with ``seed``: ``traffic["wave"]``
    requests, uids ``index * wave ...``."""
    n = int(traffic["wave"])
    key = np.random.default_rng(np.random.SeedSequence([ORDER_KEY, n]))
    prompts = key.permutation(lengths(traffic["prompt"], n))
    outputs = key.permutation(lengths(traffic["output"], n))
    r = rotation(index, n) if traffic.get("rotate", True) else 0
    order = [(i + r) % n for i in range(n)]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), index]))
    return [Draw(uid=index * n + i,
                 prompt=rng.integers(0, vocab, int(prompts[j]),
                                     dtype=np.int64).astype(np.int32),
                 max_new=int(outputs[j]))
            for i, j in enumerate(order)]


def warmup_waves(widths, vocab: int) -> List[List[Draw]]:
    """Waves that make the engine run every step width the mix can reach,
    batched and solo: for each rung ``C`` of the width ladder, two
    prompts of ``C`` tokens prefilled together (the batched step at
    ``C``, then at 1), then one alone (the solo step at ``C``, then at
    1). Fixed token ids, so that set-up does the same work in every run,
    and a different first token in each prompt, so that no admission
    shares another's pages (in-flight dedup) and skips its prefill."""
    out = []
    for c in widths:
        for n in (2, 1):
            out.append([Draw(uid=i, prompt=((np.arange(c) + i) % vocab
                                            ).astype(np.int32), max_new=2)
                        for i in range(n)])
    return out
