"""The port's sampled lanes (``repro_torch.serve.sampling``) against the
JAX package's head and engine, on the CPU.

The threefry key derivation and bits are integer arithmetic, so the port
must equal ``jax.random`` bit for bit: ``PRNGKey``, ``fold_in``,
``request_key``, ``bits`` and the uniforms the gumbel draw is made from.
The gumbel values themselves go through ``log`` twice, where torch and
XLA may round an ulp apart: they are held within 2e-6 absolute plus 1e-6
relative (values up to ~16).

Token identity with the JAX head rests on two float boundaries that two
libraries may round apart: the top-p cutoff (``cumsum(softmax)`` against
``p``) and the gumbel argmax. Each head test computes, in numpy, the
margin of both on its seeded logits (how far each row's cumulative mass
is from ``p`` and how far the winning masked+gumbel score is from the
runner-up) and requires it to exceed 1e-5 — far past the ~1e-7
disagreement of the two libraries — and then requires every token to be
identical; logprobs agree within 1e-5 absolute and relative (log-softmax
sums in another order). The engine tests require identical tokens on
SERVE_BASE, fp32 and int8 KV, and logprobs within 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.serve import sampling as jsamp
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.serve import sampling as samplib
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import DEAD_TOKEN, SamplingParams
from test_torch_bridge import jax_tree_to_numpy

PAGE = 8
MAX_LEN = 48
SEEDS = [0, 1, 7, 2 ** 31 + 5, 2 ** 40 + 3]


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# the threefry stream, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_bits_equal_jax(seed):
    assert (samplib.prng_key(seed)
            == np.asarray(jax.random.PRNGKey(seed))).all()
    for uid in (0, 1, 9, 123_456):
        assert (samplib.request_key(seed, uid)
                == jsamp.request_key(seed, uid)).all(), uid
    key = jsamp.request_key(seed, 3)
    for d in (0, 1, 17, 255, 2 ** 31, 2 ** 32 - 1):
        want = np.asarray(jax.random.fold_in(jnp.asarray(key), np.uint32(d)))
        assert (samplib.fold_in(key, d) == want).all(), d
    keys = np.stack([jsamp.request_key(seed, u) for u in range(3)])
    n = 1001                                  # odd, as a vocab may be
    bits = samplib.random_bits(_i32(keys), n).numpy().view(np.uint32)
    tiny = np.finfo(np.float32).tiny
    for i, k in enumerate(keys):
        kj = jnp.asarray(k)
        assert (bits[i] == np.asarray(jax.random.bits(kj, (n,)))).all()
        got_u = samplib.uniform_from_bits(_i32(bits[i])).numpy()
        want_u = np.asarray(jax.random.uniform(kj, (n,), minval=tiny,
                                               maxval=1.0))
        assert (got_u.view(np.int32) == want_u.view(np.int32)).all()
        got_g = samplib.gumbel_from_bits(_i32(bits[i])).numpy()
        np.testing.assert_allclose(
            got_g, np.asarray(jax.random.gumbel(kj, (n,))), atol=2e-6,
            rtol=1e-6)


def test_per_column_keys_fold_positions():
    """The head's per-column keys are ``fold_in(request key, position)``,
    computed on tensors as the step does."""
    key = jsamp.request_key(5, 2)
    pos = np.array([0, 1, 47, 4096], np.int32)
    k = _i32(key)
    o1, o2 = samplib.threefry2x32(k[0], k[1],
                                  torch.zeros(4, dtype=torch.int32),
                                  torch.from_numpy(pos))
    got = np.stack([o1.numpy(), o2.numpy()], -1).view(np.uint32)
    for j, q in enumerate(pos):
        want = np.asarray(jax.random.fold_in(jnp.asarray(key), int(q)))
        assert (got[j] == want).all()


# ---------------------------------------------------------------------------
# select_tokens against the JAX head
# ---------------------------------------------------------------------------
LANES = dict(  # greedy, temperature only, top-k, top-p, both, top-k 1
    temp=np.array([0.0, 0.7, 1.3, 0.9, 0.5, 2.0], np.float32),
    top_k=np.array([0, 0, 5, 0, 8, 1], np.int32),
    top_p=np.array([1.0, 1.0, 1.0, 0.8, 0.6, 1.0], np.float32))


def _case(seed, b=6, c=5, v=64):
    rng = np.random.default_rng(seed)
    lg = (3.0 * rng.standard_normal((b, c, v))).astype(np.float32)
    key = np.stack([jsamp.request_key(seed, u) for u in range(b)])
    pos = (rng.integers(0, 200, b)[:, None]
           + np.arange(c)).astype(np.int32)
    n_new = np.array([c, 3, 0, c, 1, c], np.int32)[:b]
    return lg, key, pos, n_new


def _margins(lg, key, pos):
    """The smallest distance of any row's top-p cumulative mass from p and
    of any sampled row's winning score from its runner-up (numpy, from
    the JAX package's own gumbel draws)."""
    b, c, v = lg.shape
    p_gap = score_gap = np.inf
    for i in range(b):
        t = LANES["temp"][i]
        if t <= 0:
            continue
        for j in range(c):
            s = lg[i, j] / max(t, 1e-6)
            desc = np.sort(s)[::-1]
            pr = np.exp(desc - desc.max())
            cum = np.cumsum(pr / pr.sum())
            p = LANES["top_p"][i]
            if p < 1.0:
                p_gap = min(p_gap, np.abs(cum - p).min())
            kc = jax.random.fold_in(jnp.asarray(key[i]), int(pos[i, j]))
            g = np.asarray(jax.random.gumbel(kc, (v,)))
            keep = np.ones(v, bool)
            k = LANES["top_k"][i]
            if k > 0:
                keep &= s >= np.sort(s)[v - min(k, v)]
            if p < 1.0:
                n_keep = int(np.sum(cum < p)) + 1
                keep &= s >= desc[n_keep - 1]
            score = np.sort(np.where(keep, s + g, -np.inf))
            if np.isfinite(score[-2]):
                score_gap = min(score_gap, score[-1] - score[-2])
    return p_gap, score_gap


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_select_tokens_equals_the_jax_head(seed):
    lg, key, pos, n_new = _case(seed)
    p_gap, score_gap = _margins(lg, key, pos)
    assert p_gap > 1e-5 and score_gap > 1e-5, (p_gap, score_gap)
    want_t, want_l = jsamp.select_tokens(
        jnp.asarray(lg), jnp.asarray(LANES["temp"]),
        jnp.asarray(LANES["top_k"]), jnp.asarray(LANES["top_p"]),
        jnp.asarray(key), jnp.asarray(pos), jnp.asarray(n_new))
    tok, logp = samplib.select_tokens(
        torch.from_numpy(lg), torch.from_numpy(LANES["temp"]),
        torch.from_numpy(LANES["top_k"]), torch.from_numpy(LANES["top_p"]),
        _i32(key), torch.from_numpy(pos), torch.from_numpy(n_new))
    assert tok.dtype == torch.int32 and logp.dtype == torch.float32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(logp.numpy(), np.asarray(want_l), atol=1e-5,
                               rtol=1e-5)


def test_head_blocks_give_the_unblocked_result(monkeypatch):
    """Rows split into blocks of a few logits each (the bound that keeps a
    wide step's temporaries small) draw the same tokens."""
    lg, key, pos, n_new = _case(5, v=40)
    args = (torch.from_numpy(lg), torch.from_numpy(LANES["temp"]),
            torch.from_numpy(LANES["top_k"]), torch.from_numpy(LANES["top_p"]),
            _i32(key), torch.from_numpy(pos), torch.from_numpy(n_new))
    whole = samplib.select_tokens(*args)
    monkeypatch.setattr(samplib, "_BLOCK_ELEMS", 3 * 40)
    blocked = samplib.select_tokens(*args)
    assert torch.equal(whole[0], blocked[0])
    assert torch.equal(whole[1], blocked[1])


def test_head_greedy_dead_columns_and_greedy_only_branch():
    """Greedy is the bitwise argmax, dead columns read the sentinel, and
    the greedy-only head (``sampled=False``) equals the full head on
    all-greedy lanes bit for bit."""
    rng = np.random.default_rng(2)
    lg = torch.from_numpy(rng.standard_normal((3, 4, 32)).astype(np.float32))
    n_new = torch.tensor([4, 2, 0], dtype=torch.int32)
    samp = {k: torch.from_numpy(v.view(np.int32) if k == "key" else v)
            for k, v in samplib.lane_inputs(3).items()}
    pos = torch.arange(4, dtype=torch.int32)[None].expand(3, 4)
    args = (lg, samp["temp"], samp["top_k"], samp["top_p"], samp["key"],
            pos, n_new)
    tok, logp = samplib.select_tokens(*args)
    tok0, logp0 = samplib.select_tokens(*args, sampled=False)
    assert torch.equal(tok, tok0) and torch.equal(logp, logp0)
    assert (tok[0] == lg[0].argmax(-1)).all()
    assert (tok[1, 2:] == DEAD_TOKEN).all() and (tok[2] == DEAD_TOKEN).all()
    assert (logp[1, 2:] == 0).all() and (logp[2] == 0).all()
    want = torch.log_softmax(lg, -1).gather(-1, lg.argmax(-1)[..., None])
    assert torch.equal(logp[0], want[0, :, 0])


def test_head_top_k_and_top_p_membership():
    rng = np.random.default_rng(4)
    b, c, v = 4, 6, 64
    lg = (3.0 * rng.standard_normal((b, c, v))).astype(np.float32)
    key = _i32(np.stack([jsamp.request_key(1, u) for u in range(b)]))
    pos = torch.arange(c, dtype=torch.int32)[None].expand(b, c)
    n_new = torch.full((b,), c, dtype=torch.int32)
    for k, p in ((1, 1.0), (3, 1.0), (0, 0.5), (8, 0.9)):
        tok, _ = samplib.select_tokens(
            torch.from_numpy(lg), torch.full((b,), 0.7),
            torch.full((b,), k, dtype=torch.int32), torch.full((b,), p),
            key, pos, n_new)
        for i in range(b):
            for j in range(c):
                s = lg[i, j] / np.float32(0.7)
                t = int(tok[i, j])
                if k:
                    assert s[t] >= np.sort(s)[-k]
                if p < 1.0:
                    pr = np.exp(s - s.max())
                    order = np.argsort(-s)
                    n_keep = int(np.sum(np.cumsum(pr[order] / pr.sum())
                                        < p)) + 1
                    assert t in order[:n_keep]
        if k == 1:                      # top_k 1 is greedy at any temp
            assert (tok.numpy() == lg.argmax(-1)).all()


def test_sampling_params_validation():
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    samp = samplib.lane_inputs(2)
    samplib.set_lane(samp, 1, SamplingParams(temperature=0.5, top_k=3,
                                             top_p=0.9, seed=8), uid=4)
    assert samp["key"][1].tolist() == jsamp.request_key(8, 4).tolist()
    samplib.set_lane(samp, 1, None)
    assert samp["temp"][1] == 0 and samp["key"][1].tolist() == [0, 0]


# ---------------------------------------------------------------------------
# engine parity with the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines(serve_cfg, serve_params, serve_cfg_int8, serve_params_int8):
    from conftest import SERVE_BASE
    out = {}
    for name, jcfg, jp, quant in (("fp32", serve_cfg, serve_params, False),
                                  ("int8", serve_cfg_int8,
                                   serve_params_int8, True)):
        pcfg = ModelConfig(name=jcfg.name, family="dense",
                           kv_cache_quant=quant, **SERVE_BASE)
        out[name] = ((jcfg, jp), (pcfg, params_from_numpy(
            jax_tree_to_numpy(jp), device="cpu")))
    return out


HOT = SamplingParams(temperature=0.8, top_k=8, top_p=0.9, seed=11,
                     logprobs=True)


def _mixed(cls, n=6, max_new=8, seed=13):
    """Greedy, temperature-only, top-k/top-p and top-k 1 lanes mixed."""
    rng = np.random.default_rng(seed)
    pols = [None, SamplingParams(temperature=0.9, seed=5), HOT,
            SamplingParams(temperature=1.5, top_k=1, seed=2, logprobs=True)]
    return [cls(uid=i, prompt=rng.integers(2, 64, int(n_p)).astype(np.int32),
                max_new_tokens=max_new, sampling=pols[i % len(pols)])
            for i, n_p in enumerate(rng.integers(5, 14, size=n))]


def _both(w, make, slots=4, **kw):
    (jcfg, jp), (pcfg, pp) = w
    jeng = JaxEngine(jcfg, jp, slots=slots, max_len=MAX_LEN, page_size=PAGE,
                     weight_plan=False, **kw)
    jout = jeng.run(make(JaxRequest))
    peng = ServeEngine(pcfg, pp, slots=slots, max_len=MAX_LEN,
                       page_size=PAGE, device="cpu", **kw)
    pout = peng.run(make(Request))
    for j, p in zip(jout, pout):
        assert p.out_tokens == j.out_tokens, (p.uid, p.out_tokens,
                                              j.out_tokens)
        np.testing.assert_allclose(p.out_logprobs, j.out_logprobs,
                                   atol=1e-5, rtol=1e-5)
    for f in ("tokens_out", "rounds", "solo_rounds", "preemptions",
              "tokens_discarded"):
        assert getattr(peng.stats, f) == getattr(jeng.stats, f), f
    return jout, pout, jeng, peng


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_engine_sampled_lanes_equal_jax(engines, kv):
    jout, pout, _, _ = _both(engines[kv], _mixed)
    greedy = _both(engines[kv], lambda cls: [
        cls(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
        for r in _mixed(cls)])[1]
    # top_k 1 is greedy; the hot lanes drew something else
    for r, g in zip(pout, greedy):
        if r.sampling is not None and r.sampling.top_k == 1:
            assert r.out_tokens == g.out_tokens
    assert any(r.out_tokens != g.out_tokens for r, g in zip(pout, greedy)
               if r.sampling is HOT)
    for r in pout:
        want = r.sampling is not None and r.sampling.logprobs
        assert len(r.out_logprobs) == (len(r.out_tokens) if want else 0)


def test_engine_sampled_solo_equals_batched(engines):
    """One sampled request alone (every round through the solo step) and
    among others (batched rounds) draws the same stream, and the JAX
    engine's."""
    make = _mixed
    _, batched, _, peng = _both(engines["fp32"], make)
    alone = [r for r in make(Request) if r.sampling is HOT][:1]
    _, solo, _, seng = _both(engines["fp32"], lambda cls: [
        cls(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
            sampling=HOT) for r in alone])
    assert seng.stats.solo_rounds == seng.stats.rounds
    want = next(r for r in batched if r.uid == alone[0].uid)
    assert solo[0].out_tokens == want.out_tokens


def test_engine_sampled_preemption_recompute_equals_jax(engines):
    """A pool too small for every slot: sampled lanes are preempted and
    recomputed, and draw the same stream again (keys fold (seed, uid,
    position) only)."""
    def make(cls):
        rng = np.random.default_rng(21)
        return [cls(uid=i, prompt=rng.integers(2, 64, 12).astype(np.int32),
                    max_new_tokens=16, sampling=HOT) for i in range(4)]
    _, pout, jeng, peng = _both(engines["fp32"], make, slots=3, n_pages=9)
    assert peng.stats.preemptions > 0
    unpressed = _both(engines["fp32"], make, slots=3)[1]
    assert [r.out_tokens for r in pout] == [r.out_tokens for r in unpressed]
