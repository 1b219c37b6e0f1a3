"""The contiguous-cache surface of the port on the CPU, against the JAX
package: ``init_cache`` / ``init_encdec_cache``, ``prefill``,
``decode_step``, the whisper encoder with decoder cross-attention, the VLM
prefix, and ``LegacyServeEngine``.

  * the caches' leaves, shapes and dtypes equal JAX's, and
    ``cache_bytes`` too;
  * ``prefill`` then three ``decode_step`` calls on the eight
    architectures of ``tests/test_models_smoke.py::
    test_smoke_decode_matches_forward`` (fp32 cache; int8 on a dense and
    a MoE stack), at capacity factor 16 as that test runs them: every
    step's logits within 1e-4 absolute plus 1e-4 relative of the JAX
    ones on the same weights and inputs (fp32 both, sums in other
    orders), and the port's decode logits within 5e-4 of its own full
    forward at the same positions (that test's bound);
  * ``LegacyServeEngine`` tokens and counters equal to JAX's
    ``LegacyServeEngine`` on reduced stablelm-1.6b and dbrx-132b (QMC
    weights, rho 0.3, the default capacity factor) and on reduced
    internvl2-2b (served text-only, as the reference does); its
    refusals (greedy only; no encoder-decoder);
  * the port's paged engine equal to its legacy engine on reduced
    dbrx-132b and jamba-1.5-large-398b with drops ruled out (capacity
    factor 16) and slots reseated, as ``tests/test_paged_serve.py`` holds
    the JAX engines.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import kvcache as jax_kv
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_params as jax_init
from repro.models.model import prefill as jax_prefill
from repro.serve.engine import LegacyServeEngine as JaxLegacy
from repro.serve.engine import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.models import kvcache as KV
from repro_torch.models.model import (decode_step, forward, init_params,
                                      prefill)
from repro_torch.serve.engine import (LegacyServeEngine, Request,
                                      ServeEngine)
from test_torch_bridge import jax_tree_to_numpy, port_params_to_jax

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["stablelm-1.6b", "gemma2-2b", "mamba2-370m",
         "jamba-1.5-large-398b", "dbrx-132b", "whisper-medium",
         "internvl2-2b", "hymba-1.5b"]
STATS = ("prefills", "decode_steps", "tokens_out")


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_reduced(arch), **kw),
            dataclasses.replace(reduced_config(arch), **kw))


def _np_tree(tree):
    return jax.tree_util.tree_map(
        lambda l: np.asarray(l.astype(jnp.float32) if l.dtype == jnp.bfloat16
                             else l), tree)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "hymba-1.5b",
                                  "whisper-medium"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_cache_layout_matches_jax(arch, quant):
    jcfg, cfg = _cfgs(arch, kv_cache_quant=quant)
    if cfg.is_encdec:
        jc = jax_kv.init_encdec_cache(jcfg, 2, 24, jnp.bfloat16)
        tc = KV.init_encdec_cache(cfg, 2, 24, torch.bfloat16, "cpu")
    else:
        jc = jax_kv.init_cache(jcfg, 2, 24, jnp.bfloat16)
        tc = KV.init_cache(cfg, 2, 24, torch.bfloat16, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jc)[0]

    def get(tree, path):
        for p in path:
            tree = tree[p.key]
        return tree
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: 0, tc)))
    for path, leaf in flat_j:
        t = get(tc, path)
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert KV.cache_bytes(tc) == jax_kv.cache_bytes(jc)


def _inputs(cfg, b=2, s=12):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    kw = {}
    if cfg.n_vis_tokens:
        kw["vis_embeds"] = rng.standard_normal(
            (b, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32) * 0.1
    if cfg.is_encdec:
        kw["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.1
    return toks, kw


@pytest.mark.parametrize("arch,quant", [(a, False) for a in ARCHS]
                         + [("stablelm-1.6b", True), ("dbrx-132b", True)])
def test_prefill_decode_match_jax(arch, quant):
    """``prefill`` over 9 of 12 tokens, then 3 ``decode_step`` calls: the
    logits of every call against JAX's on the same weights, and the decode
    logits against the port's own full forward."""
    jcfg, cfg = _cfgs(arch, capacity_factor=16.0, kv_cache_quant=quant)
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    b, s = 2, 12
    toks, kw = _inputs(cfg, b, s)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    max_len = s + cfg.n_vis_tokens + 2
    full = forward(cfg, params, torch.from_numpy(toks).long(), **tkw)
    jl, jc = jax_prefill(jcfg, jparams, jnp.asarray(toks[:, :s - 3]),
                         max_len=max_len, cache_dtype=jnp.float32, **jkw)
    tl, tc = prefill(cfg, params, torch.from_numpy(toks[:, :s - 3]).long(),
                     max_len=max_len, cache_dtype=torch.float32, **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(s - 3, s):
        pos = i + cfg.n_vis_tokens
        jl, jc = jax_decode_step(jcfg, jparams, jnp.asarray(toks[:, i:i + 1]),
                                 jc, jnp.asarray(pos))
        tl, tc = decode_step(cfg, params,
                             torch.from_numpy(toks[:, i:i + 1]).long(), tc,
                             torch.tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        if i + 1 < s and not quant:
            assert float((tl - full[:, i]).abs().max()) < 5e-4
    if cfg.is_encdec:
        # the cross K/V kept at prefill, read by every decode step
        jx = _np_tree(jc["b0"]["cross"])
        np.testing.assert_allclose(tc["b0"]["cross"]["xk"].numpy(),
                                   jx["xk"], **TOL)


# ---------------------------------------------------------------------------
# LegacyServeEngine
# ---------------------------------------------------------------------------
def _reqs(cls, vocab, n=5, seed=4):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(2, vocab, int(u)).astype(
        np.int32), max_new_tokens=int(rng.integers(3, 8)))
        for i, u in enumerate(rng.integers(4, 16, size=n))]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dbrx-132b",
                                  "internvl2-2b"])
def test_legacy_engine_matches_jax(arch):
    """QMC weights from the port's PTQ, served by both legacy engines: 5
    requests on 2 slots (slots reseated), tokens and counters equal."""
    jcfg, cfg = _cfgs(arch)
    q = quantize_for_serving(init_params(cfg, 0, device="cpu"),
                             QMCConfig(rho=0.3, granularity="subtile"),
                             min_dim=64)
    jeng = JaxLegacy(jcfg, port_params_to_jax(q), slots=2, max_len=32)
    jout = jeng.run(_reqs(JaxRequest, cfg.vocab))
    eng = LegacyServeEngine(cfg, q, slots=2, max_len=32, device="cpu")
    out = eng.run(_reqs(Request, cfg.vocab))
    assert [r.out_tokens for r in out] == [r.out_tokens for r in jout]
    for field in STATS:
        assert getattr(eng.stats, field) == getattr(jeng.stats, field), \
            field
    assert len(eng.stats.step_seconds) == eng.stats.decode_steps
    assert eng.stats.step_tokens == [1] * eng.stats.decode_steps
    assert eng.stats.wall_s > 0


def test_legacy_engine_refusals():
    cfg = reduced_config("whisper-medium")
    with pytest.raises(NotImplementedError, match="encoder"):
        LegacyServeEngine(cfg, {}, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeEngine(cfg, {}, device="cpu")
    dense = reduced_config("stablelm-1.6b")
    eng = LegacyServeEngine(dense, init_params(dense, 0, device="cpu"),
                            slots=1, max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="greedy"):
        eng.run(_reqs(Request, dense.vocab, n=1), greedy=False)


@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-1.5-large-398b"])
def test_paged_engine_matches_legacy_without_drops(arch):
    """At capacity factor 16 no assignment is dropped at any width, so
    the paged engine's tokens equal the per-slot engine's on a MoE stack
    too; 5 requests on 3 slots reseat slots, on jamba's mix of attention,
    Mamba2 and MoE layers as well (a reseated slot's SSM state reset)."""
    cfg = dataclasses.replace(reduced_config(arch), capacity_factor=16.0)
    params = init_params(cfg, 0, device="cpu")
    legacy = LegacyServeEngine(cfg, params, slots=3, max_len=32,
                               device="cpu").run(_reqs(Request, cfg.vocab))
    eng = ServeEngine(cfg, params, slots=3, max_len=32, page_size=8,
                      device="cpu")
    paged = eng.run(_reqs(Request, cfg.vocab))
    assert eng.stats.prefills == 5 > eng.slots
    assert [r.out_tokens for r in paged] == [r.out_tokens for r in legacy]
