"""The port's step set (``repro_torch.serve.steps``) on the CPU, with the
JAX package's ``tests/conftest.py:SERVE_BASE`` weights crossed over
through the numpy bridge.

On a CPU tensor the step set runs each width's body eagerly on its static
buffers (on the card the same buffers feed one CUDA graph per width), so
these tests hold the buffer plumbing to the plain functions: the static
step equals ``steps.step`` bitwise at every declared width, the solo step
on lane s equals lane s of the batched step (tokens equal; logprobs
within 1e-6 absolute plus 1e-6 relative, K/V pages within 1e-5 of both,
a few fp32 ulps of values up to ~4: the CPU matmul sums a row in another
order at batch 1 than at batch 4), and
widths never exceed ``len(width_ladder(chunk)) + 1`` per callable. Then
the chunk-size invariance of the JAX package's
``test_chunk_size_invariance_tokens_and_pages`` on the port: identical
tokens at every chunk size, and fp32 prompt pages allclose (atol and rtol
1e-5: one-token chunks take the CPU's matrix-vector route, whose sums
differ from the chunked ones by a few ulps; the JAX test asks for bitwise
pages, which XLA's reassociation rules out) with the tokens of the JAX
engine's monolithic run."""
import numpy as np
import pytest
import torch

from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import paged_init_cache
from repro_torch.serve import steps as serve_steps
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged_kv import PagedKVPool
from repro_torch.serve import sampling as samplib
from repro_torch.serve.sampling import DEAD_TOKEN, SamplingParams
from test_torch_bridge import jax_tree_to_numpy

SLOTS, PAGE, MPPS, CHUNK = 4, 8, 6, 16


@pytest.fixture(scope="module")
def port(serve_cfg, serve_params):
    from conftest import SERVE_BASE
    cfg = ModelConfig(name="t", family="dense", **SERVE_BASE)
    return cfg, params_from_numpy(jax_tree_to_numpy(serve_params),
                                  device="cpu")


def _pool(cfg, lanes):
    """A pool whose first lanes own pages for 40 positions, with its
    block tables in the arena."""
    pool = PagedKVPool(cfg, n_pages=SLOTS * MPPS, page=PAGE,
                       max_slots=SLOTS, max_pages_per_seq=MPPS,
                       device="cpu")
    arena = pool.init_arena()
    for s in range(lanes):
        pool.ensure(s, 40)
    serve_steps.apply_page_ops(arena, pool.device_tables())
    return pool, arena


def _clone(arena):
    return {k: {"attn": {n: t.clone() for n, t in g["attn"].items()}}
            for k, g in arena.items()}


def _inputs(c, seed):
    """Tokens and per-lane (start, n_new) for width c: a lane at full
    width, a shorter one, an idle lane and a decode-like lane."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, 64, size=(SLOTS, c)).astype(np.int32)
    start = np.array([3, 0, 0, 17], np.int32)
    n_new = np.array([c, max(1, c // 2), 0, 1], np.int32)
    return toks, start, n_new, samplib.lane_inputs(SLOTS)


def _dev(samp):
    """A lane_inputs table as the plain step's tensors (key as int32
    bits)."""
    return {k: torch.from_numpy(v.view(np.int32) if k == "key" else v)
            for k, v in samp.items()}


def _step_set(cfg, lanes=SLOTS):
    return serve_steps.build_paged_steps(
        cfg, page=PAGE, n_pages=SLOTS * MPPS, max_slots=lanes,
        max_pages_per_seq=MPPS, cache_dtype=torch.float32, chunk=CHUNK,
        device="cpu")


def test_static_step_equals_plain_step_at_every_width(port):
    cfg, params = port
    sset = _step_set(cfg)
    widths = (1,) + serve_steps.width_ladder(CHUNK)
    assert sset.step.widths == widths
    _, arena = _pool(cfg, SLOTS)
    plain_arena = _clone(arena)
    for i, c in enumerate(widths):
        toks, start, n_new, samp = _inputs(c, i)
        tok, logp = sset.step(params, toks, arena, start, n_new, samp)
        want_tok, want_logp = serve_steps.step(
            cfg, params, torch.from_numpy(toks), plain_arena,
            torch.from_numpy(start), torch.from_numpy(n_new), _dev(samp))
        assert torch.equal(tok, want_tok) and torch.equal(logp, want_logp)
        assert (tok[2] == DEAD_TOKEN).all()
        for key in arena:
            for name in ("k_pages", "v_pages"):
                assert torch.equal(arena[key]["attn"][name],
                                   plain_arena[key]["attn"][name])
    # one set of buffers per declared width, no more
    assert sset.step.creations == len(widths)
    assert sset.capture_counters() == (len(widths), 0, 0.0)
    with pytest.raises(ValueError, match="declared surface"):
        sset.step(params, np.zeros((SLOTS, 3), np.int32), arena,
                  *_inputs(3, 0)[1:])


@pytest.mark.parametrize("c", [1, 8])
def test_solo_step_equals_its_lane_of_the_batched_step(port, c):
    cfg, params = port
    sset = _step_set(cfg)
    _, arena = _pool(cfg, SLOTS)
    toks, _, _, samp = _inputs(c, 7)
    start = np.array([5, 0, 11, 30], np.int32)
    n_new = np.full(SLOTS, c, np.int32)
    batched = _clone(arena)
    want_tok, want_logp = sset.step(params, toks, batched, start, n_new,
                                    samp)
    want_tok, want_logp = want_tok.clone(), want_logp.clone()
    solo = _clone(arena)            # lane s writes only lane s's pages
    for s in range(SLOTS):
        tok, logp = sset.solo_step(params, toks[s:s + 1], solo,
                                   start[s:s + 1], n_new[s:s + 1],
                                   {k: v[s:s + 1] for k, v in samp.items()},
                                   slot=s)
        assert torch.equal(tok[0], want_tok[s])
        torch.testing.assert_close(logp[0], want_logp[s], atol=1e-6,
                                   rtol=1e-6)
        # K/V landed in lane s's global pages, as the batched step's did
        for key in arena:
            for name in ("k_pages", "v_pages"):
                got = solo[key]["attn"][name]
                ref = batched[key]["attn"][name]
                tbl = arena[key]["attn"]["block_tbl"][0, s].long()
                torch.testing.assert_close(got[:, tbl], ref[:, tbl],
                                           atol=1e-5, rtol=1e-5)
    assert sset.solo_step.creations == 1


def test_engine_widths_stay_within_the_declared_surface(port):
    """Prompts of many lengths through 8-token chunks: every rung and the
    solo step are used, and no callable makes buffers for more than
    ``len(width_ladder(chunk)) + 1`` widths."""
    cfg, params = port
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=rng.integers(2, 64, n).astype(np.int32),
                    max_new_tokens=4)
            for i, n in enumerate((3, 9, 21, 2, 30, 5))]
    eng = ServeEngine(cfg, params, slots=3, max_len=48, page_size=PAGE,
                      chunk_tokens=8, device="cpu")
    eng.run(reqs)
    surface = len(serve_steps.width_ladder(8)) + 1
    for fn in (eng.step_set.step, eng.step_set.solo_step):
        assert 0 < fn.creations <= surface
    assert eng.stats.solo_rounds > 0
    assert eng.stats.graph_captures == 0 and eng.stats.graph_replays == 0


def test_step_set_geometry_is_checked(port):
    cfg, params = port
    sset = _step_set(cfg)
    with pytest.raises(ValueError, match="geometry"):
        ServeEngine(cfg, params, slots=SLOTS, max_len=48, page_size=PAGE,
                    chunk_tokens=8, step_set=sset, device="cpu")
    ok = ServeEngine(cfg, params, slots=SLOTS, max_len=48, page_size=PAGE,
                     chunk_tokens=CHUNK, step_set=sset, device="cpu")
    assert ok.step_set is sset


def test_carry_decode_tokens():
    prev = torch.arange(4, dtype=torch.int32)[:, None]
    assert serve_steps.carry_decode_tokens(prev) is prev
    assert serve_steps.carry_decode_tokens(prev, 2).tolist() == [[2]]
    solo = prev[1:2]
    assert serve_steps.carry_decode_tokens(solo, 1) is solo


def test_sampled_lanes_run_and_draw_the_jax_stream(port, serve_cfg,
                                                    serve_params):
    """The engine and request the port used to refuse now run: an
    engine-default sampled policy and a per-request one draw the JAX
    engine's threefry stream, token for token."""
    cfg, params = port
    hot = SamplingParams(temperature=0.7, seed=4)
    prompt = np.arange(2, 9, dtype=np.int32)
    want = JaxRequest(uid=0, prompt=prompt, sampling=hot)
    JaxEngine(serve_cfg, serve_params, slots=2, max_len=48, page_size=PAGE,
              weight_plan=False).run([want])
    eng = ServeEngine(cfg, params, slots=2, max_len=48, page_size=PAGE,
                      device="cpu")
    req = Request(uid=0, prompt=prompt, sampling=hot)
    eng.run([req])
    assert eng.stats.rounds > 0 and req.out_tokens == want.out_tokens
    default = ServeEngine(cfg, params, slots=2, max_len=48, page_size=PAGE,
                          sampling=hot, device="cpu")
    req = Request(uid=0, prompt=prompt)
    default.run([req])
    assert req.out_tokens == want.out_tokens


def test_paged_init_cache_defaults_to_bf16_as_the_reference(port,
                                                           serve_cfg):
    from repro.models import kvcache as jax_kv
    cfg, _ = port
    arena = paged_init_cache(cfg, 3, PAGE, 2, 2, device="cpu")
    want = jax_kv.paged_init_cache(serve_cfg, 3, PAGE, 2, 2)
    assert str(want["b0"]["attn"]["k_pages"].dtype) == "bfloat16"
    assert arena["b0"]["attn"]["k_pages"].dtype == torch.bfloat16


def test_chunk_size_invariance_tokens_and_pages(port, serve_cfg,
                                                serve_params):
    cfg, params = port
    prompt = np.random.default_rng(29).integers(2, 64, 27).astype(np.int32)
    jreq = JaxRequest(uid=0, prompt=prompt.copy(), max_new_tokens=4)
    JaxEngine(serve_cfg, serve_params, slots=1, max_len=48, page_size=PAGE,
              weight_plan=False).run([jreq])

    def run(chunk):
        req = Request(uid=0, prompt=prompt.copy(), max_new_tokens=4)
        eng = ServeEngine(cfg, params, slots=1, max_len=48, page_size=PAGE,
                          chunk_tokens=chunk, device="cpu")
        eng.run([req])
        # a fresh one-slot pool hands out pages 1, 2, ... in order, so
        # the prompt's full pages are these ids at every chunk size
        ids = torch.arange(1, len(prompt) // PAGE + 1)
        return req.out_tokens, {
            f"{k}/{n}": g["attn"][n][:, ids].clone()
            for k, g in eng._arena.items() for n in ("k_pages", "v_pages")}

    ref_toks, ref_pages = run(64)                   # monolithic
    assert ref_toks == jreq.out_tokens
    for chunk in (1, 3, PAGE, PAGE + 3, 2 * PAGE):
        toks, pages = run(chunk)
        assert toks == ref_toks, chunk
        for name, leaf in pages.items():
            torch.testing.assert_close(leaf, ref_pages[name], atol=1e-5,
                                       rtol=1e-5, msg=f"chunk={chunk} {name}")
