"""The port's paged forward pass against the JAX package's, at
``reduced_config("stablelm-1.6b")`` (GQA 4/2, 25% partial rotary, qkv
bias): two ragged steps from one arena — a prefill round, then a mixed
round (decode lanes, a chunk, an idle lane) — with dense and QMC weights
and fp32 and int8 KV.

Tolerance: logits of live columns to atol/rtol 1e-4 (fp32 both sides;
sums in other orders through 2 layers and a 512-way head); the fp32
arenas' live pages to 1e-5.

The same ragged steps (dense weights, fp32 KV, the paged-attention
route), and the cache-less forward, run on reduced qwen2.5-1.5b (qkv bias,
GQA), llama-3.2-3b and gemma2-2b (``attn_local`` windows, both softcaps,
tanh-gelu, scaled and tied embeddings), to the same tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import kvcache as jax_kv
from repro.models.attention import paged_cache_write as jax_write
from repro.models.model import forward as jax_forward
from repro.models.model import init_params as jax_init
from repro_torch.bridge import arena_from_numpy, params_from_numpy
from repro_torch.configs import reduced_config
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.models.attention import paged_cache_write
from repro_torch.models.model import forward
from test_torch_bridge import jax_tree_to_numpy, port_params_to_jax

TOL = dict(atol=1e-4, rtol=1e-4)
PAGE, SLOTS, MPPS, N_PAGES = 16, 4, 3, 13
# (start, n_new) per lane for the two steps
STEPS = [(np.zeros(SLOTS, np.int32), np.array([16, 9, 0, 5], np.int32), 16),
         (np.array([16, 9, 0, 5], np.int32),
          np.array([1, 7, 0, 1], np.int32), 8)]


@pytest.fixture(scope="module")
def weights():
    cfg = jax_reduced("stablelm-1.6b")
    dense_j = jax_init(cfg, jax.random.PRNGKey(0))
    dense_p = params_from_numpy(jax_tree_to_numpy(dense_j), device="cpu")
    qmc_p = quantize_for_serving(dense_p, QMCConfig(
        rho=0.3, granularity="subtile"), min_dim=64)
    return {"dense": (dense_j, dense_p),
            "qmc": (port_params_to_jax(qmc_p), qmc_p)}


def _tables():
    ids = np.random.default_rng(0).permutation(np.arange(1, N_PAGES))
    return ids[:SLOTS * MPPS].reshape(SLOTS, MPPS).astype(np.int32)


def _arenas(quant, arch="stablelm-1.6b"):
    cfg = dataclasses.replace(jax_reduced(arch), kv_cache_quant=quant)
    arena = jax_kv.paged_init_cache(cfg, N_PAGES, PAGE, SLOTS, MPPS,
                                    jnp.float32)
    tbl = jnp.broadcast_to(jnp.asarray(_tables())[None],
                           (cfg.n_groups, SLOTS, MPPS))
    for grp in arena.values():
        grp["attn"]["block_tbl"] = tbl
    port = arena_from_numpy(jax_tree_to_numpy(arena), device="cpu")
    return cfg, arena, port


def _run_steps(weights, wkind, quant, paged_attention,
               arch="stablelm-1.6b"):
    jparams, pparams = weights[wkind]
    jcfg, jarena, parena = _arenas(quant, arch)
    pcfg = dataclasses.replace(reduced_config(arch), kv_cache_quant=quant)
    rng = np.random.default_rng(1)
    for start, n_new, c in STEPS:
        toks = rng.integers(0, jcfg.vocab, size=(SLOTS, c)).astype(np.int32)
        pos = start[:, None] + np.arange(c, dtype=np.int32)[None, :]
        want, jarena, _ = jax_forward(
            jcfg, jparams, jnp.asarray(toks), positions=jnp.asarray(pos),
            cache=jarena, valid_len=jnp.asarray(start + n_new),
            paged_attention=paged_attention)
        got = forward(pcfg, pparams, torch.from_numpy(toks).long(),
                      positions=torch.from_numpy(pos),
                      cache=parena,
                      valid_len=torch.from_numpy(start + n_new),
                      paged_attention=paged_attention)
        live = np.arange(c)[None, :] < n_new[:, None]
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], **TOL)
    if not quant:
        tbl = _tables()
        for key in jarena:
            for name in ("k_pages", "v_pages"):
                j = np.asarray(jarena[key]["attn"][name])
                p = parena[key]["attn"][name].numpy()
                live_pages = np.unique(tbl[:, :2])
                np.testing.assert_allclose(p[:, live_pages],
                                           j[:, live_pages], atol=1e-5,
                                           rtol=1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32kv", "int8kv"])
@pytest.mark.parametrize("wkind", ["dense", "qmc"])
def test_ragged_steps_match_jax(weights, wkind, quant):
    """The paged-attention route (the kernel's plain version here)."""
    _run_steps(weights, wkind, quant, paged_attention=True)


def test_gather_route_matches_jax(weights):
    """paged_attention=False: full-width gather + attend on both sides."""
    _run_steps(weights, "qmc", False, paged_attention=False)


@pytest.mark.parametrize("arch", ["qwen2.5-1.5b", "llama-3.2-3b",
                                  "gemma2-2b"])
def test_reduced_arch_logits_match_jax(arch):
    """Dense weights of each arch crossed over from JAX: the cache-less
    forward, then the two ragged steps through the paged-attention route
    (the kernel's plain version here)."""
    cfg = jax_reduced(arch)
    dense_j = jax_init(cfg, jax.random.PRNGKey(0))
    dense_p = params_from_numpy(jax_tree_to_numpy(dense_j), device="cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 24)).astype(np.int32)
    want = jax_forward(cfg, dense_j, jnp.asarray(toks))
    if isinstance(want, tuple):
        want = want[0]
    got = forward(reduced_config(arch), dense_p,
                  torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _run_steps({"dense": (dense_j, dense_p)}, "dense", False, True, arch)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32kv", "int8kv"])
def test_cache_write_of_padding_lands_on_null_page(quant):
    """Columns at or past valid_len write page 0 only; every live page
    holds exactly what the JAX write puts there."""
    cfg, jarena, parena = _arenas(quant)
    jc = jax.tree_util.tree_map(lambda l: l[0], jarena["b0"]["attn"])
    pc = {k: v[0] for k, v in parena["b0"]["attn"].items()}
    before = {k: v.clone() for k, v in pc.items()}
    rng = np.random.default_rng(2)
    k = rng.standard_normal((SLOTS, 8, 2, 32)).astype(np.float32)
    v = rng.standard_normal((SLOTS, 8, 2, 32)).astype(np.float32)
    start = np.array([0, 13, 30, 3], np.int32)
    valid = start + np.array([8, 2, 0, 5], np.int32)
    pos = start[:, None] + np.arange(8, dtype=np.int32)[None, :]
    out = jax_write(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                    valid_len=jnp.asarray(valid))
    paged_cache_write(pc, torch.from_numpy(k), torch.from_numpy(v),
                      torch.from_numpy(pos), valid_len=torch.from_numpy(valid))
    for name in ("k_pages", "v_pages"):
        got = pc[name].to(torch.float32).numpy()
        want = np.asarray(out[name]).astype(np.float32)
        np.testing.assert_allclose(got[1:], want[1:], atol=1e-6)
        assert not torch.equal(pc[name][0], before[name][0])
        # every column past valid_len went to the null page: the live
        # pages hold only the valid tokens' writes
        tbl = _tables()
        for b in range(SLOTS):
            for t in range(8):
                p = int(pos[b, t])
                if p < valid[b] or p // PAGE >= MPPS:
                    continue
                row = got[tbl[b, p // PAGE], p % PAGE]
                assert (row == before[name][tbl[b, p // PAGE],
                                            p % PAGE].float().numpy()).all()
