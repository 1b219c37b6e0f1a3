"""The port's pipelined round loop (``ServeEngine(pipelined=True)``) on the
CPU, against its own synchronous loop and against the JAX package's
``ServeEngine(pipelined=True, weight_plan=False)`` on the same weights
(``tests/conftest.py:SERVE_BASE``, crossed over through the numpy bridge).

Tokens must be identical in all three, at 1, 4 and 8 slots, on the lanes
of ``tests/test_pipeline.py``: greedy, sampled (temperature, top-k and
top-p) and speculative (k = 3, whose rounds never overlap), and
``rounds``, ``solo_rounds``, ``pipelined_rounds``, ``pipeline_barriers``
and ``lag_trimmed_tokens`` equal to the JAX engine's. The EOS-in-lag cases
of ``tests/test_pipeline.py`` are matched: one lane overruns its EOS by
exactly the token in flight, which is trimmed and never emitted, and the
pool ends at rest."""
import numpy as np
import pytest

from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams
from test_torch_bridge import jax_tree_to_numpy

PAGE = 8
MAX_LEN = 48
STATS = ("rounds", "solo_rounds", "pipelined_rounds", "pipeline_barriers",
         "lag_trimmed_tokens", "tokens_out", "decode_steps", "spec_rounds",
         "spec_draft_tokens", "spec_accepted_tokens")


@pytest.fixture(scope="module")
def weights(serve_cfg, serve_params):
    from conftest import SERVE_BASE
    cfg = ModelConfig(name="t", family="dense", **SERVE_BASE)
    return (serve_cfg, serve_params), (cfg, params_from_numpy(
        jax_tree_to_numpy(serve_params), device="cpu"))


def _reqs(cls, n=6, max_new=6, seed=3, eos_id=None, sampling=None):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(2, 64, int(u)).astype(np.int32),
                max_new_tokens=max_new, eos_id=eos_id, sampling=sampling)
            for i, u in enumerate(rng.integers(4, 14, size=n))]


def _port(weights, slots, **kw):
    cfg, params = weights[1]
    return ServeEngine(cfg, params, slots=slots, max_len=MAX_LEN,
                       page_size=PAGE, device="cpu", **kw)


def _jax(weights, slots, **kw):
    cfg, params = weights[0]
    return JaxEngine(cfg, params, slots=slots, max_len=MAX_LEN,
                     page_size=PAGE, weight_plan=False, **kw)


def _pool_at_rest(eng):
    pool = eng._pool
    pool.check_tables()
    assert pool.free_count == pool.n_pages
    assert not any(pool.slot_pages)


def _three_ways(weights, slots, make, **kw):
    """Port sync, port pipelined and JAX pipelined on the same requests;
    returns the two pipelined engines after the token checks."""
    sync = _port(weights, slots, **kw)
    out_s = sync.run(make(Request))
    pipe = _port(weights, slots, pipelined=True, **kw)
    out_p = pipe.run(make(Request))
    jeng = _jax(weights, slots, pipelined=True, **kw)
    out_j = jeng.run(make(JaxRequest))
    toks = [r.out_tokens for r in out_s]
    assert [r.out_tokens for r in out_p] == toks
    assert [r.out_tokens for r in out_j] == toks
    assert sync.stats.pipelined_rounds == 0
    for field in STATS:
        assert getattr(pipe.stats, field) == getattr(jeng.stats, field), \
            field
    assert pipe.stats.tokens_out == sync.stats.tokens_out
    _pool_at_rest(pipe)
    return pipe, jeng


@pytest.mark.parametrize("slots", [1, 4, 8])
def test_pipelined_tokens_match_sync_and_jax(weights, slots):
    pipe, _ = _three_ways(weights, slots, lambda cls: _reqs(cls))
    assert pipe.stats.pipelined_rounds > 0
    assert 0 < pipe.stats.pipeline_overlap <= 1
    if slots == 1:
        assert pipe.stats.solo_rounds == pipe.stats.rounds


SAMPLED = dict(temperature=0.8, top_k=8, top_p=0.9, seed=11)


@pytest.mark.parametrize("slots", [1, 4, 8])
@pytest.mark.parametrize("lane", ["sampled", "speculative"])
def test_pipelined_lanes_match_sync_and_jax(weights, lane, slots):
    """The other lanes of ``tests/test_pipeline.py``: sampled lanes overlap
    like greedy ones; an engine with speculative decode never overlaps."""
    if lane == "sampled":
        def make(cls):
            sp = (SamplingParams if cls is Request
                  else JaxSamplingParams)(**SAMPLED)
            return _reqs(cls, sampling=sp)
        pipe, _ = _three_ways(weights, slots, make)
        assert pipe.stats.pipelined_rounds > 0
    else:
        pipe, _ = _three_ways(weights, slots, lambda cls: _reqs(cls),
                              speculative_k=3)
        assert pipe.stats.pipelined_rounds == 0


def _probe_eos(weights, max_new=8):
    """A token of the greedy stream whose first occurrence lands in
    [2, 6), so an EOS cut happens while a round is in flight (the JAX
    test's probe, on the port)."""
    out = _port(weights, 1).run([Request(
        uid=0, prompt=np.arange(2, 12, dtype=np.int32),
        max_new_tokens=max_new)])
    toks = out[0].out_tokens
    for t in toks:
        if 2 <= toks.index(t) < 6:
            return t
    pytest.fail(f"greedy stream {toks} has no mid-run token to use as EOS")


@pytest.mark.parametrize("slots", [1, 4])
def test_eos_during_lag_trims_the_overrun(weights, slots):
    eos = _probe_eos(weights)

    def make(cls):
        return [cls(uid=0, prompt=np.arange(2, 12, dtype=np.int32),
                    max_new_tokens=8, eos_id=eos)]

    pipe, _ = _three_ways(weights, slots, make)
    assert pipe.stats.lag_trimmed_tokens == 1
    assert pipe.stats.pipelined_rounds > 0


def test_eos_during_lag_several_lanes(weights):
    eos = _probe_eos(weights)
    pipe, _ = _three_ways(weights, 4, lambda cls: _reqs(cls, max_new=8,
                                                        eos_id=eos))
    assert pipe.stats.pipelined_rounds > 0


def test_admissions_drain_the_pipeline(weights):
    """More requests than slots: admission rounds drain the pipeline
    between overlapped decode rounds, at the JAX engine's points."""
    pipe, _ = _three_ways(weights, 2, lambda cls: _reqs(cls, n=7, seed=9))
    assert pipe.stats.pipelined_rounds > 0
    assert pipe.stats.pipeline_barriers >= 1
