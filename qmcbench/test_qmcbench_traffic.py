"""The traffic generator: the same requests for the same seed, the same
set of lengths for every seed and wave, inside the mix's clips, in an
order drawn once from a fixed key and rotated from wave to wave."""
import numpy as np
import pytest

from qmcbench import spec, traffic


@pytest.mark.parametrize("mix", ["chat", "chat-long", "longdoc"])
def test_waves_are_seeded_clipped_and_equal_in_work(mix):
    t = spec.load_cell({"chat": "stablelm-1.6b.chat",
                        "chat-long": "hymba-1.5b.chat-long",
                        "longdoc": "stablelm-1.6b.longdoc"}[mix]).traffic
    seed = 2 ** 31 + 987654321          # past 32 signed bits
    a = traffic.wave(t, 1000, seed, 3)
    b = traffic.wave(t, 1000, seed, 3)
    assert [d.uid for d in a] == [d.uid for d in b] == list(
        range(3 * t["wave"], 4 * t["wave"]))
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               for x, y in zip(a, b))
    other = traffic.wave(t, 1000, seed + 1, 3)
    assert any(not np.array_equal(x.prompt, y.prompt)
               for x, y in zip(a, other))
    for w in (a, other, traffic.wave(t, 1000, 7, 0)):
        plens = sorted(len(d.prompt) for d in w)
        outs = sorted(d.max_new for d in w)
        assert plens == traffic.lengths(t["prompt"], t["wave"])
        assert outs == traffic.lengths(t["output"], t["wave"])
        assert t["prompt"]["min"] <= plens[0] <= plens[-1] \
            <= t["prompt"]["max"]
        assert t["output"]["min"] <= outs[0] <= outs[-1] \
            <= t["output"]["max"]
        assert all(len(d.prompt) + d.max_new <= t["max_len"] for d in w)
        assert all(0 <= d.prompt.min() and d.prompt.max() < 1000 for d in w)
    n = t["wave"]
    shapes = [[(len(d.prompt), d.max_new) for d in traffic.wave(
        t, 1000, seed, k)] for k in range(5)]
    for k, s in enumerate(shapes):
        r = traffic.rotation(k, n) if t.get("rotate", True) else 0
        assert s == shapes[0][r:] + shapes[0][:r]
    assert len({traffic.rotation(k, n) for k in range(5)}) == 5


@pytest.mark.parametrize("mix", ["chat", "chat-long", "longdoc"])
def test_order_is_random_and_the_same_for_every_seed(mix):
    """No length decides the order: outputs are not listed longest first,
    and over a rotating run's waves the longest output comes at every
    place; every seed sends the same lengths in the same order, with other
    token ids."""
    t = spec.load_cell({"chat": "stablelm-1.6b.chat",
                        "chat-long": "hymba-1.5b.chat-long",
                        "longdoc": "stablelm-1.6b.longdoc"}[mix]).traffic
    n = t["wave"]
    places = set()
    for k in range(20 * n):
        outs = [d.max_new for d in traffic.wave(dict(t, rotate=True), 1000,
                                                5, k)]
        places.add(outs.index(max(outs)))
        assert outs != sorted(outs, reverse=True)
    assert places == set(range(n))
    for k in range(3):
        a, b = (traffic.wave(t, 1000, s, k) for s in (5, 2 ** 31 + 9))
        assert [(len(x.prompt), x.max_new) for x in a] == \
            [(len(y.prompt), y.max_new) for y in b]
        assert any(not np.array_equal(x.prompt, y.prompt)
                   for x, y in zip(a, b))


def test_lengths_follow_the_lognormal():
    got = traffic.lengths({"median": 100, "sigma": 0.5, "min": 1,
                           "max": 10 ** 6}, 101)
    assert got[50] == 100 and got == sorted(got)
    assert traffic.lengths({"median": 100, "sigma": 5.0, "min": 50,
                            "max": 120}, 8) == [50] * 4 + [120] * 4


def test_warmup_reaches_every_width_batched_and_solo():
    waves = traffic.warmup_waves((4, 8, 16), 512)
    assert [[len(d.prompt) for d in w] for w in waves] == [
        [4, 4], [4], [8, 8], [8], [16, 16], [16]]
    first_tokens = {int(d.prompt[0]) for d in waves[4]}
    assert len(first_tokens) == 2         # no dedup between the pair
