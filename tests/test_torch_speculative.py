"""The port's self-speculative decode (``repro_torch.serve.speculative``
and the engine's ``speculative_k``) against the JAX package's, on the CPU.

``propose`` and ``accept_greedy`` are host numpy: on seeded random
histories they must return exactly what the JAX functions return. The
engine with ``speculative_k`` 2 and 4 on ``tests/conftest.py:SERVE_BASE``
must give the JAX engine's tokens (``weight_plan=False``) and plain
greedy's, with the same verify rounds, draft and accepted counts; sampled
lanes never verify; and an EOS inside an accepted draft ends the request
at the EOS, as plain decode does."""
import dataclasses

import numpy as np
import pytest

from repro.serve import speculative as jspec
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.serve import speculative
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams
from test_torch_bridge import jax_tree_to_numpy

PAGE = 8
MAX_LEN = 48
STATS = ("tokens_out", "rounds", "solo_rounds", "decode_steps",
         "spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
         "kv_pages_live", "page_op_flushes", "device_tables_rebuilds")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_propose_and_accept_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        hist = rng.integers(0, 4, int(rng.integers(0, 30)))
        k = int(rng.integers(0, 6))
        n = int(rng.integers(1, 4))
        got = speculative.propose(hist, k, max_ngram=n)
        want = jspec.propose(hist, k, max_ngram=n)
        assert got.dtype == want.dtype and (got == want).all()
        draft = rng.integers(0, 3, int(rng.integers(0, 5)))
        sel = rng.integers(0, 3, int(rng.integers(1, 7)))
        assert speculative.accept_greedy(draft, sel) == \
            jspec.accept_greedy(draft, sel)


@pytest.fixture(scope="module")
def weights(serve_cfg, serve_params):
    from conftest import SERVE_BASE
    cfg = ModelConfig(name="t", family="dense", **SERVE_BASE)
    return (serve_cfg, serve_params), (cfg, params_from_numpy(
        jax_tree_to_numpy(serve_params), device="cpu"))


def _rep(cls, n=3, max_new=12, seed=29, sampling=None, eos_id=None):
    """Repetitive prompts, so the prompt-lookup draft fires."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=np.tile(rng.integers(2, 64, 4), 4).astype(
        np.int32), max_new_tokens=max_new, sampling=sampling, eos_id=eos_id)
        for i in range(n)]


def _run(weights, make, **kw):
    (jcfg, jp), (pcfg, pp) = weights
    jeng = JaxEngine(jcfg, jp, slots=4, max_len=MAX_LEN, page_size=PAGE,
                     weight_plan=False, **kw)
    jout = jeng.run(make(JaxRequest))
    peng = ServeEngine(pcfg, pp, slots=4, max_len=MAX_LEN, page_size=PAGE,
                       device="cpu", **kw)
    pout = peng.run(make(Request))
    assert [r.out_tokens for r in pout] == [r.out_tokens for r in jout]
    for f in STATS:
        assert getattr(peng.stats, f) == getattr(jeng.stats, f), f
    pool = peng._pool
    pool.check_tables()
    assert pool.free_count == pool.n_pages
    return pout, peng


@pytest.mark.parametrize("k", [2, 4])
def test_speculative_equals_jax_and_plain_greedy(weights, k):
    base, _ = _run(weights, _rep)
    out, eng = _run(weights, _rep, speculative_k=k)
    assert [r.out_tokens for r in out] == [r.out_tokens for r in base]
    s = eng.stats
    assert s.spec_rounds > 0 and s.spec_draft_tokens > 0
    assert 0 < s.spec_acceptance_rate <= 1


def test_speculative_sampled_lanes_fall_back(weights):
    sp = SamplingParams(temperature=0.9, seed=2)
    plain, _ = _run(weights, lambda cls: _rep(cls, sampling=sp))
    out, eng = _run(weights, lambda cls: _rep(cls, sampling=sp),
                    speculative_k=4)
    assert eng.stats.spec_rounds == 0
    assert [r.out_tokens for r in out] == [r.out_tokens for r in plain]


def test_eos_truncates_speculative_acceptance(weights):
    """A verify round of this request accepts a draft token after a token
    the request has not emitted before; with that token as its EOS, the
    round's acceptance is cut at the EOS, and the request ends as plain
    decode ends it."""
    def one(cls, eos_id=None):
        return [dataclasses.replace(_rep(cls, max_new=24, seed=154)[2],
                                    eos_id=eos_id)]
    spec, eng = _run(weights, one, speculative_k=4)
    toks, i, eos = spec[0].out_tokens, 0, None
    for n in eng.stats.step_tokens:      # one request: a round's tokens
        for j in range(n - 1):
            if eos is None and toks.index(toks[i + j]) == i + j:
                eos = toks[i + j]
        i += n
    assert eos is not None
    plain, _ = _run(weights, lambda cls: one(cls, eos))
    out, eng = _run(weights, lambda cls: one(cls, eos), speculative_k=4)
    assert out[0].out_tokens == plain[0].out_tokens
    assert out[0].out_tokens[-1] == eos
    assert eos not in out[0].out_tokens[:-1]
    assert eng.stats.spec_accepted_tokens > 0
