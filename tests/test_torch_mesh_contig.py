"""The contiguous prefill and decode on a rank mesh (``serve.steps.
build_prefill`` / ``build_decode``, ``launch.sharding.cache_spec`` /
``local_cache`` / ``shard_cache``, ``models.model.prefill`` /
``decode_step`` on a rank's rows, slices and cache), against the JAX
package's contiguous ``build_prefill`` / ``build_decode`` and the port's
one process.

Gloo ranks spawned on the CPU, one spawn per mesh shape, (1, 2) and
(2, 2) (the rank function is ``test_torch_mesh_contig_ranks.contig_job``,
which imports no JAX): reduced whisper-medium and internvl2-2b (vocab
509: the embedding and the head replicate over ``model``, as at their
published widths) and a dense stack with one KV head (its attention
replicates over ``model``), ``B`` = 4 rows of 6 prompt tokens, prefill
then 4 greedy decode steps, every call's logits gathered to ``[B, V]``:

  * on the bridged dense weights against JAX ``build_prefill`` /
    ``build_decode``'s ``fn`` jitted on a one-device (1, 1) mesh, both
    on fp32 caches (JAX's ``fn`` calls ``prefill`` at its bf16 default,
    patched here to fp32: the two frameworks' K/V differ by ulps, and a
    bf16 cache rounds a few of those entries to neighbouring values,
    ~1e-3 on a decode logit): logits at
    ``tests/test_torch_contiguous.py``'s TOL (atol 1e-4, rtol 1e-4) and
    greedy tokens equal;
  * on QMC streams quantized after the shard (each rank its shard alone)
    against the port's one process on the same conversion
    (``quantize_for_serving(tp_shards=2)``, every shard, no mesh): the
    same tolerance, tokens equal;
  * the rank's cache: its rows, its KV columns (1 / M of them, all of
    them where the KV heads do not divide ``model``), its cross K/V
    heads; the only collectives the ``tp`` sums and the gathers of the
    logits (``logits``).

``cache_spec`` against JAX's, leaf by leaf, for a reduced config of every
family at (2, 2), for a batch that divides the dp axis and one that does
not, with the departures ``launch.sharding.cache_spec`` names applied to
JAX's spec (the cross heads, the Mamba2 state's heads; the sequence cut
over ``data`` for a batch that does not divide it is JAX's own), and
``shard_cache`` against ``local_cache``'s shapes.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime_context as jax_rctx  # noqa: F401
from repro.configs import reduced_config as jax_reduced
from repro.launch import mesh as jax_meshlib
from repro.launch.sharding import _path_str
from repro.launch.sharding import cache_spec as jax_cache_spec
from repro.launch.sharding import logits_spec as jax_logits_spec
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import init_params as jax_init
from repro.serve import steps as jax_steps
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ASSIGNED_ARCHS, reduced_config
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import DryMesh, spawn
from repro_torch.models.layers import attn_replicated
from repro_torch.models.model import decode_step, prefill
from repro_torch.serve import steps as S
from test_torch_bridge import jax_tree_to_numpy
from test_torch_mesh_contig_ranks import (B, CACHE_DTYPE, CASES, SEQ, STEPS,
                                          cache_len, case_cfg, contig_job,
                                          make_inputs)

TOL = dict(atol=1e-4, rtol=1e-4)
TIMEOUT_S = 300.0
SHAPES = [(1, 2), (2, 2)]
NAMES = [c[0] for c in CASES]


def _jax_cfg(pcfg) -> JaxModelConfig:
    return JaxModelConfig(**{f.name: getattr(pcfg, f.name)
                             for f in dataclasses.fields(JaxModelConfig)})


def _ids(shape):
    return "x".join(map(str, shape))


@pytest.fixture(scope="module")
def reference():
    """Per case: the JAX parameters' numpy copy, the inputs, and the
    logits and greedy tokens of JAX's ``build_prefill`` / ``build_decode``
    on a (1, 1) mesh."""
    mesh = jax_meshlib.make_mesh((1, 1), ("data", "model"))
    out = {}
    for name in NAMES:
        cfg = case_cfg(name)
        jcfg = _jax_cfg(cfg)
        jparams = jax_init(jcfg, jax.random.PRNGKey(0))
        inputs = make_inputs(cfg)
        n = cache_len(cfg)
        pf, _ = jax_steps.build_prefill(jcfg, mesh, batch=B, seq=SEQ,
                                        cache_len=n)
        dc, _ = jax_steps.build_decode(jcfg, mesh, batch=B, cache_len=n)
        dc = jax.jit(dc)
        extras = {k: jnp.asarray(v) for k, v in inputs.items()
                  if k != "tokens"}
        fp32 = functools.partial(jax_steps._prefill,
                                 cache_dtype=jnp.float32)
        with mock.patch.object(jax_steps, "_prefill", fp32):
            lg, cache = jax.jit(pf)(jparams, jnp.asarray(inputs["tokens"]),
                                    extras)
        logits, fed = [np.asarray(lg)], []
        for i in range(STEPS):
            nxt = np.argmax(logits[-1], axis=-1).astype(np.int32)
            fed.append(nxt)
            lg, cache = dc(jparams, jnp.asarray(nxt[:, None]), cache,
                           jnp.asarray(SEQ + cfg.n_vis_tokens + i))
            logits.append(np.asarray(lg))
        out[name] = dict(numpy=jax_tree_to_numpy(jparams), inputs=inputs,
                         logits=np.stack(logits, 1),
                         tokens=np.stack(fed, 1))
    return out


def _one_process(cfg, params, inputs):
    """The port's one process: prefill and greedy decode steps, no mesh."""
    toks = torch.from_numpy(inputs["tokens"]).long()
    extras = {k: torch.from_numpy(v) for k, v in inputs.items()
              if k != "tokens"}
    with torch.no_grad():
        lg, cache = prefill(cfg, params, toks, max_len=cache_len(cfg),
                            cache_dtype=CACHE_DTYPE, **extras)
        logits, fed = [lg], []
        for i in range(STEPS):
            nxt = torch.argmax(logits[-1], dim=-1)
            fed.append(nxt)
            lg, cache = decode_step(cfg, params, nxt.reshape(-1, 1), cache,
                                    SEQ + cfg.n_vis_tokens + i)
            logits.append(lg)
    return torch.stack(logits, 1), torch.stack(fed, 1)


@pytest.fixture(scope="module")
def runs(reference):
    """The port's one process on streams quantized after the shard (2
    shards, every one), then each mesh shape's spawn."""
    params = {n: params_from_numpy(reference[n]["numpy"], device="cpu")
              for n in NAMES}
    inputs = {n: reference[n]["inputs"] for n in NAMES}
    qmc = QMCConfig(rho=0.3, granularity="subtile")
    out = {"one": {}}
    for name in NAMES:
        cfg = case_cfg(name)
        whole_attn = attn_replicated(cfg, 2)
        q = quantize_for_serving(params[name], qmc, tp_shards=2)
        if whole_attn:      # a replicated block runs whole streams
            qw = quantize_for_serving(params[name], qmc)
            q = _pick_attn(q, qw)
        out["one"][name] = _one_process(cfg, q, inputs[name])
    job = {"cases": NAMES, "params": params, "inputs": inputs}
    for shape in SHAPES:
        out[shape] = spawn(contig_job, shape, backend="gloo", args=(job,),
                           timeout_s=TIMEOUT_S)
    return out


def _pick_attn(cut, whole, path=""):
    if isinstance(cut, dict):
        return {k: _pick_attn(cut[k], whole[k], f"{path}/{k}")
                for k in cut}
    return whole if "/attn/" in path + "/" and path.split("/")[-1] in (
        "wq", "wk", "wv", "wo") else cut


@pytest.mark.parametrize("case", NAMES)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_mesh_contiguous_matches_jax_steps(runs, reference, shape, case):
    ref = reference[case]
    for r in runs[shape]:
        got = r["cases"][case]["dense"]
        np.testing.assert_allclose(got["logits"].numpy(), ref["logits"],
                                   err_msg=f"{shape} {case} rank "
                                   f"{r['rank']}", **TOL)
        assert np.array_equal(got["tokens"].numpy(), ref["tokens"])


@pytest.mark.parametrize("case", NAMES)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_mesh_contiguous_quantized_after_shard_matches_one_process(
        runs, shape, case):
    logits, tokens = runs["one"][case]
    for r in runs[shape]:
        got = r["cases"][case]["quant"]
        np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(),
                                   err_msg=f"{shape} {case} rank "
                                   f"{r['rank']}", **TOL)
        assert torch.equal(got["tokens"], tokens)


@pytest.mark.parametrize("case", NAMES)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_rank_cache_and_collectives(runs, shape, case):
    """A rank holds its rows and its KV columns (all of them where the KV
    heads do not divide ``model``) and its cross K/V heads; the only
    collectives are the ``tp`` sums and the logits' gathers."""
    cfg = case_cfg(case)
    d, m = shape
    kv_heads = cfg.n_kv_heads if attn_replicated(cfg, m) \
        else cfg.n_kv_heads // m
    for r in runs[shape]:
        got = r["cases"][case]
        g = cfg.n_layers if cfg.is_encdec else cfg.n_groups
        assert got["k_shape"] == (g, B // d, cache_len(cfg),
                                  kv_heads * cfg.head_dim)
        if cfg.is_encdec:
            assert got["xk_shape"] == (cfg.n_layers, B // d, cfg.enc_seq,
                                       kv_heads, cfg.head_dim)
        gathers = (1 + STEPS) * (int(cfg.vocab % m == 0) + int(d > 1))
        assert got["by_kind"].pop("logits", 0) == gathers
        assert set(got["by_kind"]) == {"tp"}


# ---------------------------------------------------------------------------
# cache_spec against JAX's
# ---------------------------------------------------------------------------
FAMILY_ARCHS = list(ASSIGNED_ARCHS) + ["hymba-1.5b"]


def _departed(path, jspec, leaf, cfg, mesh, batch):
    """JAX's spec with the port's named departures applied."""
    spec = list(jspec) + [None] * (len(leaf.shape) - len(jspec))
    tp = mesh.devices.shape[list(mesh.axis_names).index("model")]
    split_heads = not attn_replicated(cfg, tp)
    if path.endswith(("/k", "/v", "k_scale", "v_scale")):
        if not split_heads:
            spec[3] = None
    elif path.endswith(("xk", "xv")):
        if split_heads and leaf.shape[3] % tp == 0:
            spec[3] = "model"                  # the rank's cross heads
    elif path.endswith(("/ssm", "/conv")):
        spec[2:] = [None] * (len(spec) - 2)    # the mixer whole
    return tuple(spec)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("batch", [4, 3])
def test_cache_spec_matches_jax(arch, batch):
    cfg, jcfg = reduced_config(arch), jax_reduced(arch)
    mesh = DryMesh((2, 2), ("data", "model"))
    jstruct = jax_steps.cache_struct(jcfg, batch, 8)
    flat = jax.tree_util.tree_flatten_with_path(jstruct)[0]
    port = dict(_leaves(S.cache_struct(cfg, batch, 8)))
    assert len(flat) == len(port)
    for p, leaf in flat:
        path = _path_str(p)
        mine = shd.cache_spec("/" + path, port["/" + path], mesh, batch,
                              cfg)
        mine = tuple(mine) + (None,) * (len(leaf.shape) - len(mine))
        want = _departed(path, tuple(jax_cache_spec(path, leaf, mesh,
                                                    batch)), leaf, cfg,
                         mesh, batch)
        assert mine == want, (arch, batch, path)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-2b",
                                  "hymba-1.5b", "dbrx-132b"])
@pytest.mark.parametrize("batch", [4, 3])
def test_shard_cache_gives_local_cache_shapes(arch, batch):
    """A whole cache cut by ``shard_cache`` has ``local_cache``'s leaves
    and the rank's rows, positions (the sequence cut of a batch that does
    not divide the data axis) and columns of every leaf, on every
    rank."""
    cfg = reduced_config(arch)
    gen = torch.Generator().manual_seed(0)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        return torch.randn(tree.shape, generator=gen).to(tree.dtype)
    whole = fill(S.cache_struct(cfg, batch, 8, torch.float32))
    for rank in range(4):
        mesh = DryMesh((2, 2), ("data", "model"), rank)
        cut = dict(_leaves(shd.shard_cache(whole, mesh, batch, cfg)))
        want = dict(_leaves(shd.local_cache(cfg, batch, 8, torch.float32,
                                            "cpu", mesh)))
        assert {k: tuple(v.shape) for k, v in cut.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        rows = shd.batch_rows(mesh, batch)
        seq = shd.seq_slice(mesh, batch, 8)
        pos = (slice(None) if seq is None
               else slice(seq[0], seq[0] + seq[1]))
        for path, leaf in _leaves(whole):
            if path.endswith("/k"):
                m = mesh.index("model")
                n = cut[path].shape[-1]
                np.testing.assert_array_equal(
                    cut[path].numpy(),
                    leaf[:, rows, pos, m * n:(m + 1) * n].numpy())


def test_logits_spec_matches_jax():
    mesh = DryMesh((2, 2), ("data", "model"))
    cfg = reduced_config("stablelm-1.6b")
    for batch in (4, 3):
        assert shd.logits_spec(mesh, batch) == tuple(
            jax_logits_spec(mesh, batch))
        assert S.logits2d(mesh, batch, cfg) == (
            "data" if batch % 2 == 0 else None, "model")
    odd = dataclasses.replace(cfg, vocab=509)
    assert S.logits2d(mesh, 4, odd) == ("data", None)
