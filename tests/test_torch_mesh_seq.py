"""The sequence-parallel contiguous cache (``launch.sharding.cache_spec`` /
``seq_slice`` / ``local_cache``, ``serve.steps.build_prefill`` /
``build_decode``): where the global batch does not divide the dp axes,
JAX cuts the K/V sequence over ``data``, and so does the port. A data
rank runs every row, holds positions ``[d T / D, (d + 1) T / D)`` of the
cache, writes the step's K/V only where they land in its cut, attends
over its positions at their global key positions (causal mask, window,
``valid``; ``models.attention.attend_partial``, a row with no live key
``(0, -1e30, 0)``) and the slices merge over ``data`` (``merge``).

Gloo ranks spawned on the CPU at (2, 1) and (2, 2), one spawn per shape
(the rank function is ``test_torch_mesh_seq_ranks.seq_job``): reduced
hymba-1.5b (the hybrid stack of the ``long_500k`` cell), whisper-medium,
internvl2-2b and stablelm-1.6b at batch 1 and batch 3, a prompt of 6
tokens (internvl's 8 visual embeddings before it) into a cache of twice
one past it, then 4 greedy decode steps at tensor positions, the second
of which crosses into data rank 1's half: every call's gathered logits
against JAX's ``build_prefill`` / ``build_decode`` jitted on a one-device
(1, 1) mesh, both on fp32 caches (``tests/test_torch_mesh_contig.py``'s
reason and tolerance: atol 1e-4, rtol 1e-4), greedy tokens equal; a
rank's cache holds every row and half the positions; the merges count
two an attention layer a call.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import mesh as jax_meshlib
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import init_params as jax_init
from repro.serve import steps as jax_steps
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import DryMesh, spawn
from repro_torch.models.layers import attn_replicated
from test_torch_bridge import jax_tree_to_numpy
from test_torch_mesh_seq_ranks import (ARCHS, BATCHES, SEQ, STEPS,
                                       cache_len, case_cfg, make_inputs,
                                       seq_job)

TOL = dict(atol=1e-4, rtol=1e-4)
TIMEOUT_S = 300.0
SHAPES = [(2, 1), (2, 2)]
CASES = [(a, b) for a in ARCHS for b in BATCHES]


def _jax_cfg(pcfg) -> JaxModelConfig:
    return JaxModelConfig(**{f.name: getattr(pcfg, f.name)
                             for f in dataclasses.fields(JaxModelConfig)})


def _ids(x):
    return "x".join(map(str, x)) if isinstance(x, tuple) else str(x)


@pytest.fixture(scope="module")
def reference():
    """Per arch the JAX parameters' numpy copy; per case the inputs and
    the logits and greedy tokens of JAX's builders on a (1, 1) mesh."""
    mesh = jax_meshlib.make_mesh((1, 1), ("data", "model"))
    params, out = {}, {}
    for arch in ARCHS:
        cfg = case_cfg(arch)
        jcfg = _jax_cfg(cfg)
        jparams = jax_init(jcfg, jax.random.PRNGKey(0))
        params[arch] = jax_tree_to_numpy(jparams)
        n = cache_len(cfg)
        fp32 = functools.partial(jax_steps._prefill,
                                 cache_dtype=jnp.float32)
        for b in BATCHES:
            inputs = make_inputs(cfg, b)
            pf, _ = jax_steps.build_prefill(jcfg, mesh, batch=b, seq=SEQ,
                                            cache_len=n)
            dc, _ = jax_steps.build_decode(jcfg, mesh, batch=b,
                                           cache_len=n)
            extras = {k: jnp.asarray(v) for k, v in inputs.items()
                      if k != "tokens"}
            with mock.patch.object(jax_steps, "_prefill", fp32):
                lg, cache = jax.jit(pf)(jparams,
                                        jnp.asarray(inputs["tokens"]),
                                        extras)
            dc = jax.jit(dc)
            logits, fed = [np.asarray(lg)], []
            for i in range(STEPS):
                nxt = np.argmax(logits[-1], axis=-1).astype(np.int32)
                fed.append(nxt)
                lg, cache = dc(jparams, jnp.asarray(nxt[:, None]), cache,
                               jnp.asarray(SEQ + cfg.n_vis_tokens + i))
                logits.append(np.asarray(lg))
            out[(arch, b)] = dict(inputs=inputs, logits=np.stack(logits, 1),
                                  tokens=np.stack(fed, 1))
    return params, out


@pytest.fixture(scope="module")
def runs(reference):
    params, cases = reference
    job = {"cases": CASES,
           "params": {a: params_from_numpy(params[a], device="cpu")
                      for a in ARCHS},
           "inputs": {c: cases[c]["inputs"] for c in CASES}}
    return {shape: spawn(seq_job, shape, backend="gloo", args=(job,),
                         timeout_s=TIMEOUT_S) for shape in SHAPES}


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sequence_cut_matches_jax_steps(runs, reference, shape, case):
    ref = reference[1][case]
    for r in runs[shape]:
        got = r["cases"][case]
        np.testing.assert_allclose(got["logits"].numpy(), ref["logits"],
                                   err_msg=f"{shape} {case} rank "
                                   f"{r['rank']}", **TOL)
        assert np.array_equal(got["tokens"].numpy(), ref["tokens"])


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_rank_holds_half_the_positions_and_merges(runs, shape, case):
    """A rank's self-attention cache holds every row of the batch, its KV
    columns and ``T / 2`` positions; each call merges the two slices once
    an attention layer (a MAX and a SUM)."""
    arch, b = case
    cfg = case_cfg(arch)
    d, m = shape
    n = cache_len(cfg)
    kv = cfg.n_kv_heads if attn_replicated(cfg, m) \
        else cfg.n_kv_heads // m
    n_attn = (cfg.n_layers if cfg.is_encdec else cfg.n_groups * sum(
        k.startswith(("attn", "hybrid")) for k in cfg.pattern))
    for r in runs[shape]:
        got = r["cases"][case]
        assert got["k_shape"][1:] == (b, n // d, kv * cfg.head_dim)
        assert got["by_kind"]["merge"] == 2 * n_attn * (1 + STEPS)
        assert r["seq"] == (r["rank"] // m * 4, 4, 8)


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_cache_spec_and_local_cache_of_the_cut(batch):
    """At (2, 2): the K/V of a batch that does not divide ``data`` take
    ``(None, None, "data", heads)``, one that does ``(None, "data", None,
    heads)``; ``local_cache`` allocates ``T / 2`` positions of every row,
    or every position of the rank's rows; a cache whose length does not
    divide ``data`` keeps every position."""
    cfg = case_cfg("hymba-1.5b")
    mesh = DryMesh((2, 2), ("data", "model"), 3)
    leaf = torch.empty((cfg.n_groups, batch, 8, cfg.kv_dim),
                       device="meta")
    cut = batch % 2 != 0
    assert shd.cache_spec("/b0/attn/k", leaf, mesh, batch, cfg) == (
        None, None if cut else "data", "data" if cut else None, "model")
    local = shd.local_cache(cfg, batch, 8, torch.float32, "meta", mesh)
    k = local["b0"]["attn"]["k"]
    assert tuple(k.shape[1:3]) == ((batch, 4) if cut else (batch // 2, 8))
    assert shd.seq_slice(mesh, batch, 8) == ((4, 4, 8) if cut else None)
    assert shd.seq_slice(mesh, batch, 7) is None
