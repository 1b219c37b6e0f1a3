"""The rounds rebuilt from the tracer against the engine's counters, on
the CPU at a small size (the engine runs the same host loop there)."""
import copy

import pytest

from qmcbench import harness, rounds, traffic
from qmcbench.smallcell import small_cell


def _wave(name, seed, **kw):
    from repro_torch.obs.trace import Tracer
    cell = small_cell(name, **kw)
    tracer = Tracer(enabled=True)
    eng = harness.build_engine(cell, seed, "cpu", tracer)
    draws = traffic.wave(cell.traffic, cell.config["model"]["vocab"], seed,
                         0)
    eng.run(harness.requests_of(draws))
    return cell, tracer.events, draws, eng.stats


@pytest.mark.parametrize("name", ["stablelm-1.6b.chat",
                                  "hymba-1.5b.chat-long"])
def test_rebuild_agrees_with_the_engine(name):
    cell, events, draws, stats = _wave(name, 11, wave=8)
    got = rounds.rebuild(events, draws, cell.traffic["chunk"], stats)
    assert len(got) == stats.rounds and stats.pipelined_rounds > 0
    assert any(r.solo for r in got) and any(len(r.lanes) > 1 for r in got)
    assert {r.c for r in got} > {1}
    hybrid = name.startswith("hymba")
    # a hybrid stack never decodes in a round that holds a chunk
    assert hybrid == all(not (r.prefill and r.decode) for r in got)
    for r in got:
        assert r.rows(4) == r.c * (1 if r.solo else 4)
        for ln in r.decode:
            assert ln.n == 1


def test_rebuild_refuses_what_the_counters_deny():
    cell, events, draws, stats = _wave("stablelm-1.6b.chat", 12)
    broken = copy.deepcopy(events)
    drop = next(i for i, e in enumerate(broken)
                if e["name"] == "req/chunk_done")
    del broken[drop]
    with pytest.raises(rounds.Mismatch):
        rounds.rebuild(broken, draws, cell.traffic["chunk"], stats)
    wrong = copy.deepcopy(stats)
    wrong.prefill_tokens_padded += 1
    with pytest.raises(rounds.Mismatch):
        rounds.rebuild(events, draws, cell.traffic["chunk"], wrong)


@pytest.mark.parametrize("name", ["stablelm-1.6b.chat",
                                  "hymba-1.5b.chat-long"])
def test_traced_run_rebuilds_every_wave(name):
    """A ``--trace 1`` run with the profiler left out (no card here): the
    tracer is on in every wave, each wave's rounds are rebuilt and checked,
    and ``mfu`` is read over them; the device's metrics find nothing."""
    cell = small_cell(name, trace_waves=0)
    r = harness.run_cell(cell, 2 ** 31 + 77, 1.0, True, device="cpu")
    got = r["metrics"]
    assert r["correct"] and set(got) == {"host_share", "tokens_per_round",
                                         "mfu"}
    assert 0 < got["mfu"]["value"] < 100
