"""Hybrid and mamba stacks on the port, on the CPU, against the JAX package.

  * the cache-less forward of ``reduced_config("hymba-1.5b")`` and
    ``reduced_config("mamba2-370m")``, then two ragged paged steps from one
    arena (a chunk round, then decode lanes beside a chunk and an idle
    lane): logits of live columns within 1e-4 absolute plus 1e-4 relative
    (fp32 both sides, sums in other orders through the SSD scan and a
    512-way head), the arena's ``ssm`` and ``conv`` rows within 1e-5
    (the conv rows hold ``in_proj`` outputs of the second layer group,
    a few fp32 ulps of values up to ~4 apart), the idle lane's rows bit
    for bit as they were;
  * the engine on ``tests/test_paged_serve.py``'s hybrid config and on a
    tiny mamba config, 8 requests on 4 slots (slots are reused), greedy
    tokens synchronous and pipelined equal to JAX's ``LegacyServeEngine``
    (not JAX's ``ServeEngine``: its paged engine can lose a state reset,
    see ``ROADMAP.md`` C), and the engine counters equal to JAX
    ``ServeEngine``'s in the same mode (its decisions do not depend on the
    tokens);
  * the counterpart of ``test_hybrid_chunked_idle_lane_state_neutral``:
    a decode lane idling through another prompt's chunk rounds, one of
    them a one-token chunk (the s == 1 recurrence), keeps its state;
  * the step set: the solo step writes its lane's state back (tokens
    equal to the batched step's, rows within 1e-5); the page-ops flush
    zeroes exactly the reset slots' rows;
  * the refusals and the dedup default, as ``tests/test_sharded_serve.py``
    checks them, and the CLI on both archs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import kvcache as jax_kv
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import forward as jax_forward
from repro.models.model import init_params as jax_init
from repro.serve.engine import LegacyServeEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import arena_from_numpy, params_from_numpy
from repro_torch.configs import reduced_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward
from repro_torch.serve import sampling as samplib
from repro_torch.serve import steps as serve_steps
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_bridge import jax_tree_to_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
PAGE, SLOTS, MPPS, N_PAGES = 16, 4, 3, 13
# (start, n_new, width) per lane for the two steps: a chunk round (lane 2
# idle), then decode lanes beside a chunk and the idle lane
STEPS = [(np.zeros(SLOTS, np.int32), np.array([16, 9, 0, 5], np.int32), 16),
         (np.array([16, 9, 0, 5], np.int32),
          np.array([1, 7, 0, 1], np.int32), 8)]

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=64)
CONFIGS = {
    "hybrid": dict(name="th", family="hybrid", pattern=("hybrid",),
                   d_state=16, ssm_headdim=32, **BASE),
    "mamba": dict(name="t-mamba", family="ssm", n_layers=2, d_model=64,
                  n_heads=0, n_kv_heads=0, head_dim=1, d_ff=0, vocab=128,
                  pattern=("mamba",), d_state=16, ssm_headdim=16),
}
STATS = ("rounds", "decode_steps", "prefills", "prefill_chunks",
         "prefill_tokens", "prefill_tokens_padded", "solo_rounds",
         "pipelined_rounds", "pipeline_barriers", "lag_trimmed_tokens",
         "page_op_flushes", "page_ops_batched", "kv_pages_live",
         "kv_pages_full", "prefill_kv_pages_live", "tokens_out",
         "dedup_hits")


def _tables():
    ids = np.random.default_rng(0).permutation(np.arange(1, N_PAGES))
    return ids[:SLOTS * MPPS].reshape(SLOTS, MPPS).astype(np.int32)


def _arenas(cfg):
    """One arena on both sides: shuffled block tables and, as if earlier
    tokens had run, random pages and SSM / conv rows."""
    arena = jax_kv.paged_init_cache(cfg, N_PAGES, PAGE, SLOTS, MPPS,
                                    jnp.float32)
    rng = np.random.default_rng(7)
    for grp in arena.values():
        if "attn" in grp:
            for name in ("k_pages", "v_pages"):
                grp["attn"][name] = jnp.asarray(rng.standard_normal(
                    grp["attn"][name].shape).astype(np.float32))
            grp["attn"]["block_tbl"] = jnp.broadcast_to(
                jnp.asarray(_tables())[None], grp["attn"]["block_tbl"].shape)
        if "mamba" in grp:
            for name in ("ssm", "conv"):
                grp["mamba"][name] = jnp.asarray(0.3 * rng.standard_normal(
                    grp["mamba"][name].shape).astype(np.float32))
    return arena, arena_from_numpy(jax_tree_to_numpy(arena), device="cpu")


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-370m"])
def test_reduced_arch_matches_jax(arch):
    jcfg = jax_reduced(arch)
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    jfwd = jax.jit(functools.partial(jax_forward, jcfg))
    cfg = reduced_config(arch)
    params = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 24)).astype(np.int32)
    want = jfwd(jparams, jnp.asarray(toks))[0]
    got = forward(cfg, params, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jarena, parena = _arenas(jcfg)
    idle = {k: {n: t[:, 2].clone() for n, t in g["mamba"].items()}
            for k, g in parena.items()}
    rng = np.random.default_rng(1)
    for start, n_new, c in STEPS:
        toks = rng.integers(0, cfg.vocab, size=(SLOTS, c)).astype(np.int32)
        pos = start[:, None] + np.arange(c, dtype=np.int32)[None, :]
        want, jarena, _ = jfwd(
            jparams, jnp.asarray(toks), positions=jnp.asarray(pos),
            cache=jarena, valid_len=jnp.asarray(start + n_new))
        got = forward(cfg, params, torch.from_numpy(toks).long(),
                      positions=torch.from_numpy(pos), cache=parena,
                      valid_len=torch.from_numpy(start + n_new),
                      paged_attention=True)
        live = np.arange(c)[None, :] < n_new[:, None]
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], **TOL)
    for key, grp in parena.items():
        for name, tol in (("ssm", 1e-5), ("conv", 1e-5)):
            np.testing.assert_allclose(
                grp["mamba"][name].numpy(),
                np.asarray(jarena[key]["mamba"][name]), atol=tol, rtol=tol)
            assert torch.equal(grp["mamba"][name][:, 2], idle[key][name])
        if "attn" in grp:
            live_pages = np.unique(_tables()[:, :2])
            for name in ("k_pages", "v_pages"):
                np.testing.assert_allclose(
                    grp["attn"][name].numpy()[:, live_pages],
                    np.asarray(jarena[key]["attn"][name])[:, live_pages],
                    atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    out = {}
    for name, kw in CONFIGS.items():
        jcfg = JaxModelConfig(**kw)
        jp = jax_init(jcfg, jax.random.PRNGKey(0))
        out[name] = (jcfg, jp, ModelConfig(**kw),
                     params_from_numpy(jax_tree_to_numpy(jp), device="cpu"))
    return out


def _reqs(cls, vocab, n=8, max_new=6, seed=5, lo=4, hi=14):
    """``tests/test_paged_serve.py:_requests``."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(2, vocab, size=int(L)).astype(
        np.int32), max_new_tokens=max_new)
        for i, L in enumerate(rng.integers(lo, hi, size=n))]


@pytest.fixture(scope="module")
def legacy_tokens(weights):
    out = {}
    for name, (jcfg, jp, _, _) in weights.items():
        reqs = _reqs(JaxRequest, jcfg.vocab)
        LegacyServeEngine(jcfg, jp, slots=4, max_len=32).run(reqs)
        out[name] = [r.out_tokens for r in reqs]
    return out


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
@pytest.mark.parametrize("name", ["hybrid", "mamba"])
def test_engine_matches_jax(weights, legacy_tokens, name, pipelined):
    jcfg, jp, cfg, params = weights[name]
    eng = ServeEngine(cfg, params, slots=4, max_len=32, page_size=8,
                      device="cpu", pipelined=pipelined)
    reqs = eng.run(_reqs(Request, cfg.vocab))
    assert [r.out_tokens for r in reqs] == legacy_tokens[name]
    jeng = JaxEngine(jcfg, jp, slots=4, max_len=32, page_size=8,
                     pipelined=pipelined)
    jeng.run(_reqs(JaxRequest, jcfg.vocab))
    for field in STATS:
        assert getattr(eng.stats, field) == getattr(jeng.stats, field), \
            field
    assert eng.step_set.reset_state is not None
    # every seat queued one reset, flushed with its round's page ops
    assert eng.stats.page_ops_batched >= len(reqs)
    if pipelined:
        assert eng.stats.pipelined_rounds > 0


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_hybrid_chunked_idle_lane_state_neutral(weights, seed):
    """A decode lane idling through another prompt's chunk rounds (n_new
    = 0: hybrid stacks do not co-schedule) keeps its SSM / conv state; the
    17-token prompt's last chunk is one token, a C = 1 chunk round through
    the s == 1 recurrence (``tests/test_paged_serve.py``)."""
    jcfg, jp, cfg, params = weights["hybrid"]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, 64, 5).astype(np.int32),
               rng.integers(2, 64, 17).astype(np.int32)]

    def reqs(cls):
        return [cls(uid=0, prompt=prompts[0], max_new_tokens=10),
                cls(uid=1, prompt=prompts[1], max_new_tokens=4)]
    legacy = reqs(JaxRequest)
    LegacyServeEngine(jcfg, jp, slots=2, max_len=32).run(legacy)
    eng = ServeEngine(cfg, params, slots=2, max_len=32, page_size=8,
                      chunk_tokens=16, device="cpu")
    got = eng.run(reqs(Request))
    assert [r.out_tokens for r in got] == [r.out_tokens for r in legacy]
    assert eng.stats.prefill_chunks == 3          # 5 | 16 + 1


def test_reused_slot_gets_a_fresh_engines_tokens(weights):
    """One slot, pipelined: every request after the first is seated into
    the slot its predecessor's state was left in, and must get the tokens
    it gets alone on a fresh engine (the reset rides in the page-ops
    upload)."""
    _, _, cfg, params = weights["hybrid"]
    reqs = _reqs(Request, cfg.vocab, n=3)
    eng = ServeEngine(cfg, params, slots=1, max_len=32, page_size=8,
                      device="cpu", pipelined=True)
    seq = eng.run(reqs)
    for r in reqs:
        fresh = ServeEngine(cfg, params, slots=1, max_len=32, page_size=8,
                            device="cpu", pipelined=True)
        alone = fresh.run([Request(uid=r.uid, prompt=r.prompt,
                                   max_new_tokens=r.max_new_tokens)])
        assert alone[0].out_tokens == seq[r.uid].out_tokens


# ---------------------------------------------------------------------------
# the step set
# ---------------------------------------------------------------------------
def _step_arena(cfg):
    jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
    return _arenas(jcfg)[1]


def test_solo_step_writes_back_its_lane_state(weights):
    _, _, cfg, params = weights["hybrid"]
    sset = serve_steps.build_paged_steps(
        cfg, page=PAGE, n_pages=N_PAGES - 1, max_slots=SLOTS,
        max_pages_per_seq=MPPS, cache_dtype=torch.float32, chunk=16,
        device="cpu")
    toks = np.random.default_rng(2).integers(2, 64, (SLOTS, 1)).astype(
        np.int32)
    start = np.array([5, 9, 2, 30], np.int32)
    n_new = np.ones(SLOTS, np.int32)
    samp = samplib.lane_inputs(SLOTS)
    batched = _step_arena(cfg)
    solo = _step_arena(cfg)
    want, _ = sset.step(params, toks, batched, start, n_new, samp)
    want = want.clone()
    for s in range(SLOTS):
        tok, _ = sset.solo_step(params, toks[s:s + 1], solo, start[s:s + 1],
                                n_new[s:s + 1],
                                {k: v[s:s + 1] for k, v in samp.items()},
                                slot=s)
        assert torch.equal(tok[0], want[s])
    # within 1e-5 (as tests/test_torch_steps.py holds the solo step's K/V
    # pages): the CPU matmul sums a row in another order at batch 1
    for key in solo:
        for name in ("ssm", "conv"):
            torch.testing.assert_close(solo[key]["mamba"][name],
                                       batched[key]["mamba"][name],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["hybrid", "mamba"])
def test_page_ops_reset_zeroes_only_the_reset_slots(weights, name):
    _, _, cfg, _ = weights[name]
    arena = _step_arena(cfg)
    before = {k: {n: t.clone() for n, t in g["mamba"].items()}
              for k, g in arena.items()}
    ops = serve_steps.PageOps(SLOTS, MPPS, torch.device("cpu"))
    tables = _tables()
    ops(arena, tables, resets=[1, 3])
    for key, grp in arena.items():
        for n, leaf in grp["mamba"].items():
            assert not leaf[:, [1, 3]].any()
            assert torch.equal(leaf[:, [0, 2]], before[key][n][:, [0, 2]])
        if "attn" in grp:
            assert torch.equal(grp["attn"]["block_tbl"][0],
                               torch.from_numpy(tables))
    ops(arena, tables)                # no reset: nothing else changes
    serve_steps.reset_state(arena, 0)
    for grp in arena.values():
        assert not grp["mamba"]["ssm"][:, [0, 1, 3]].any()
        assert grp["mamba"]["ssm"][:, 2].any()


# ---------------------------------------------------------------------------
# refusals, the dedup default, the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,match", [
    (dict(prefix_cache=True), "prefix caching"),
    (dict(inflight_dedup=True), "in-flight dedup"),
    (dict(speculative_k=2), "self-speculative decode")])
def test_refusals_on_hybrid(weights, kw, match):
    _, _, cfg, params = weights["hybrid"]
    with pytest.raises(NotImplementedError, match=match):
        ServeEngine(cfg, params, slots=2, max_len=32, device="cpu", **kw)


def test_dedup_default_follows_the_stack(weights, serve_cfg):
    _, _, cfg, params = weights["hybrid"]
    assert ServeEngine(cfg, params, slots=2, max_len=32,
                       device="cpu")._dedup is False
    dense = ModelConfig(**{f.name: getattr(serve_cfg, f.name)
                           for f in dataclasses.fields(serve_cfg)})
    from repro_torch.models.model import init_params
    eng = ServeEngine(dense, init_params(dense, 0, device="cpu"), slots=2,
                      max_len=32, device="cpu")
    assert eng._dedup is True and eng._co_schedule is True


SMALL = ["--device", "cpu", "--requests", "3", "--prompt-len", "6",
         "--new-tokens", "4"]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-370m"])
def test_cli_serves_hybrid_and_ssm(arch, capsys):
    eng = serve_cli.main(SMALL + ["--arch", arch])
    assert eng.stats.tokens_out == 12
    assert eng.cfg.pattern == reduced_config(arch).pattern
    assert "12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("flag,match", [
    (["--prefix-cache"], "prefix caching"),
    (["--speculative", "2"], "self-speculative decode")])
def test_cli_refuses_with_the_engines_message(flag, match, capsys):
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(SMALL + ["--arch", "hymba-1.5b"] + flag)
    assert exc.value.code != 0
    assert match in capsys.readouterr().err
