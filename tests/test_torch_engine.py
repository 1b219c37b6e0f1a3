"""The port's ServeEngine (on the CPU: every kernel wrapper runs its plain
version) against the JAX package's ServeEngine on reduced stablelm-1.6b
with QMC streams: 4 requests of distinct lengths, 2 slots, greedy.
Tokens must be identical — same admission, chunking and preemption
decisions, same argmax — and so must the round counts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import reduced_config as jax_reduced
from repro.models.model import init_params as jax_init
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_bridge import jax_tree_to_numpy, port_params_to_jax

PROMPT_LENS = (5, 17, 9, 13)
NEW_TOKENS = 6


@pytest.fixture(scope="module")
def qmc_weights():
    cfg = jax_reduced("stablelm-1.6b")
    dense = params_from_numpy(jax_tree_to_numpy(
        jax_init(cfg, jax.random.PRNGKey(0))), device="cpu")
    qport = quantize_for_serving(dense, QMCConfig(
        rho=0.3, granularity="subtile"), min_dim=64)
    return port_params_to_jax(qport), qport


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def run_both(weights, *, quant, weight_plan, jax_paged_attention=True,
             port_weight_plan=None, **engine_kw):
    jparams, pparams = weights
    jcfg = dataclasses.replace(jax_reduced("stablelm-1.6b"),
                               kv_cache_quant=quant)
    pcfg = dataclasses.replace(reduced_config("stablelm-1.6b"),
                               kv_cache_quant=quant)
    prompts = _prompts(jcfg.vocab)
    jeng = JaxEngine(jcfg, jparams, slots=2, max_len=32,
                     cache_dtype=jnp.float32,
                     paged_attention=jax_paged_attention,
                     weight_plan=weight_plan, **engine_kw)
    jreqs = [JaxRequest(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    peng = ServeEngine(pcfg, pparams, slots=2, max_len=32,
                       paged_attention=True,
                       weight_plan=(weight_plan if port_weight_plan is None
                                    else port_weight_plan),
                       device="cpu", **engine_kw)
    preqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
             for i, p in enumerate(prompts)]
    peng.run(preqs)
    for j, p in zip(jreqs, preqs):
        assert len(p.out_tokens) == NEW_TOKENS and p.done
        assert p.out_tokens == j.out_tokens, (p.uid, p.out_tokens,
                                              j.out_tokens)
    js, ps = jeng.stats, peng.stats
    for field in ("tokens_out", "rounds", "prefills", "prefill_chunks",
                  "decode_steps", "preemptions", "tokens_discarded",
                  "kv_pages_live", "prefill_kv_pages_live"):
        assert getattr(ps, field) == getattr(js, field), field
    return js, ps


@pytest.mark.parametrize("quant", [False, True], ids=["fp32kv", "int8kv"])
def test_tokens_match_jax_engine_streams(qmc_weights, quant):
    """weight_plan=False on both sides: the streams go through qmm."""
    run_both(qmc_weights, quant=quant, weight_plan=False)


def test_chunked_prefill_co_scheduled_matches_jax(qmc_weights):
    """8-token chunks co-scheduled with decode lanes: the width ladder's
    rungs and the per-round budget decide identically."""
    _, ps = run_both(qmc_weights, quant=False, weight_plan=False,
                     chunk_tokens=8)
    assert ps.prefill_chunks > len(PROMPT_LENS)
