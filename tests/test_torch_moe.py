"""Mixture-of-experts stacks on the port, on the CPU, against the JAX package.

  * ``moe_block`` against ``repro.models.moe.moe_block`` on the same
    inputs: with capacity drops (capacity factor 1.0, a router that
    overloads experts) and without (16.0), dense and QTensor experts,
    gated silu and ungated gelu; ``y`` within 1e-5 absolute plus 1e-5
    relative (fp32 both; the expert products sum in other orders) and
    the aux loss within 1e-6;
  * the serving format of a ``[G, E, d, ff]`` leaf (a ``[G][E]`` list of
    QTensors, lowered by ``build_exec_weights`` to one dense tensor),
    ``quantize_model``'s handling of 4-D leaves, and the bridge's
    ``[G, E]`` / ``[G, 1]`` stack marking;
  * the paged engine on ``reduced_config("dbrx-132b")`` at the default
    capacity factor 1.25 (drops happen at every step width), greedy,
    sampled, speculative and prefix-cache lanes, and on
    ``reduced_config("jamba-1.5-large-398b")`` greedy (4 requests on 4
    slots: no slot is reseated, so the JAX engine's lost-reset race of
    ``ROADMAP.md`` C cannot show): tokens and counters equal to the JAX
    ``ServeEngine(weight_plan=False, paged_attention=True)`` on the same
    QMC weights (the port's PTQ, crossed over). The capacity counts every
    row of a step, padding rows included, so the paged engine is held
    against the paged engine, both on the ragged attention kernel's
    route, where padding rows attend to nothing;
  * the MoE term of the per-width cost count: E x 3 expert products at
    the step's capacity rows and the router, on ``tiny_moe``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.core.qconfig import QMCConfig as JaxQMCConfig
from repro.core.qtensor import QTensor as JaxQTensor
from repro.core.qtensor import dequantize_qtensor as jax_dequantize
from repro.core.qtensor import quantize_qtensor as jax_quantize
from repro.core.serving_quant import quantize_for_serving as jax_q4s
from repro.models.moe import moe_block as jax_moe_block
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config
from repro_torch.core.apply import quantize_model
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import (QTensor, dequantize_qtensor,
                                      quantize_qtensor)
from repro_torch.core.serving_quant import (build_exec_weights,
                                            is_stream_leaf,
                                            quantize_for_serving)
from repro_torch.launch import roofline as rl
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.models.moe import capacity, moe_block
from repro_torch.obs.costs import step_work
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged_kv import PagedKVPool
from repro_torch.serve.sampling import SamplingParams
from test_torch_bridge import jax_tree_to_numpy, port_params_to_jax

QMC = dict(rho=0.3, granularity="subtile")
STATS = ("rounds", "decode_steps", "prefills", "prefill_chunks",
         "prefill_tokens", "solo_rounds", "tokens_out", "cache_hits",
         "cache_hit_tokens", "dedup_hits", "cow_copies", "spec_rounds",
         "spec_draft_tokens", "spec_accepted_tokens")


def _port_cfg(jcfg, **kw) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)}, **kw)


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------
def _moe_inputs(jcfg, seed):
    rng = np.random.default_rng(seed)
    d, ff, e = jcfg.d_model, jcfg.d_ff, jcfg.n_experts
    p = {"router": rng.standard_normal((d, e)).astype(np.float32) * 0.3,
         "w_up": rng.standard_normal((e, d, ff)).astype(np.float32)
         / math.sqrt(d),
         "w_down": rng.standard_normal((e, ff, d)).astype(np.float32)
         / math.sqrt(ff)}
    if jcfg.gated_mlp:
        p["w_gate"] = rng.standard_normal((e, d, ff)).astype(
            np.float32) / math.sqrt(d)
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    return p, x


def _drops(cfg, router, x) -> int:
    """Assignments past their expert's capacity for this call."""
    xf = x.reshape(-1, x.shape[-1])
    ids = np.argsort(-(xf @ router), axis=-1)[:, :cfg.topk]
    counts = np.bincount(ids.reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(counts - capacity(xf.shape[0], cfg), 0).sum())


@pytest.mark.parametrize("experts", ["dense", "qtensor"])
@pytest.mark.parametrize("cf", [1.0, 16.0], ids=["drops", "no-drops"])
@pytest.mark.parametrize("arch", ["tiny_moe", "dbrx-132b", "gelu"])
def test_moe_block_matches_jax(request, arch, cf, experts):
    if arch == "dbrx-132b":
        jcfg = jax_reduced(arch)
    else:
        jcfg = request.getfixturevalue("tiny_moe")
        if arch == "gelu":
            jcfg = dataclasses.replace(jcfg, act="gelu", gated_mlp=False)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    cfg = _port_cfg(jcfg)
    p, x = _moe_inputs(jcfg, seed=5)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if experts == "qtensor":
        # every expert whose (din, dout) tiles (8, 128) becomes a QTensor
        # stack over E: the serving format's per-group slice
        qcfg = JaxQMCConfig(**QMC)
        for name, w in p.items():
            if name != "router" and w.shape[1] % 8 == 0 \
                    and w.shape[2] % 128 == 0:
                qs = [jax_quantize(jnp.asarray(w[e]), qcfg)
                      for e in range(w.shape[0])]
                jp[name] = jax.tree_util.tree_map(
                    lambda *ls: jnp.stack(ls), *qs)
        assert any(isinstance(v, JaxQTensor) for v in jp.values())
    y_j, aux_j = jax_moe_block(jp, jnp.asarray(x), jcfg)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    if experts == "qtensor":
        assert any(isinstance(v, list) for v in tp.values())
    y, aux = moe_block(tp, torch.from_numpy(x), cfg)
    drops = _drops(cfg, p["router"], x)
    assert (drops > 0) == (cf == 1.0), drops
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_j), atol=1e-6,
                               rtol=1e-6)


def test_moe_block_static_shapes(tiny_moe):
    """The capacity is the reference's formula over every row, at least
    k; the block's outputs keep x's shape and dtype, and a dropped
    assignment contributes nothing (a token whose every choice is dropped
    comes out as zeros)."""
    cfg = _port_cfg(dataclasses.replace(tiny_moe, capacity_factor=0.01))
    assert capacity(32, cfg) == cfg.topk
    assert capacity(32, dataclasses.replace(cfg, capacity_factor=1.25)) \
        == math.ceil(32 * 2 / 4 * 1.25)
    p, x = _moe_inputs(cfg, seed=2)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y, aux = moe_block(tp, torch.from_numpy(x), cfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.ndim == 0
    # with cap = k = 2 per expert at most 8 of the 32 tokens' 64
    # assignments survive, so most tokens come out as exact zeros
    zero_rows = (y.reshape(-1, cfg.d_model) == 0).all(dim=-1).sum()
    assert int(zero_rows) >= 32 - 8


# ---------------------------------------------------------------------------
# the serving format, quantize_model, the bridge
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dbrx_port():
    cfg = reduced_config("dbrx-132b")
    return cfg, init_params(cfg, 0, device="cpu")


def test_serving_format_of_expert_stacks(dbrx_port):
    cfg, params = dbrx_port
    q = quantize_for_serving(params, QMCConfig(**QMC), min_dim=64)
    ffn = q["blocks"]["b0"]["ffn"]
    assert isinstance(ffn["router"], torch.Tensor)       # [G, d, E]: dense
    for name in ("w_up", "w_gate", "w_down"):
        leaf, dense = ffn[name], params["blocks"]["b0"]["ffn"][name]
        assert is_stream_leaf(leaf)
        assert len(leaf) == cfg.n_groups
        assert all(len(row) == cfg.n_experts for row in leaf)
        assert all(isinstance(qt, QTensor) for row in leaf for qt in row)
        one = quantize_qtensor(dense[1, 2], QMCConfig(**QMC))
        assert torch.equal(leaf[1][2].in_codes, one.in_codes)
        assert torch.equal(leaf[1][2].scale_in, one.scale_in)
    lowered = build_exec_weights(q)
    w = lowered["blocks"]["b0"]["ffn"]["w_down"]
    assert w.shape == (cfg.n_groups, cfg.n_experts, cfg.d_ff, cfg.d_model)
    assert torch.equal(w[1, 3], dequantize_qtensor(
        ffn["w_down"][1][3], torch.float32))
    assert lowered["blocks"]["b0"]["ffn"]["router"] is ffn["router"]


def test_quantize_model_on_expert_stacks(dbrx_port):
    """``qtensor`` leaves 4-D leaves dense, as the reference does; the
    fake-quant methods quantize every (group, expert) matrix apart."""
    cfg, params = dbrx_port
    dense = params["blocks"]["b0"]["ffn"]["w_up"]
    qt = quantize_model(params, "qtensor", qmc=QMCConfig(**QMC))
    assert qt["blocks"]["b0"]["ffn"]["w_up"] is dense
    assert isinstance(qt["lm_head"], QTensor)
    rtn = quantize_model(params, "rtn4")["blocks"]["b0"]["ffn"]["w_up"]
    assert rtn.shape == dense.shape
    one = quantize_model({"w": dense[1, 3]}, "rtn4")["w"]
    assert torch.equal(rtn[1, 3], one)
    assert not torch.equal(rtn, dense)


def test_bridge_marks_expert_and_shard_stacks():
    """Two stack dims cross over only when marked: a JAX MoE stack
    ``[G, E]`` (E = 1 included) becomes a ``[G][E]`` list, a stacked
    one-shard ShardedQTensor ``[G, 1]`` a per-group list."""
    rng = np.random.default_rng(0)
    for e in (1, 3):
        tree = {"ffn": {"w_up": jnp.asarray(rng.standard_normal(
                    (2, e, 16, 256)).astype(np.float32))},
                "attn": {"wq": jnp.asarray(rng.standard_normal(
                    (2, 16, 256)).astype(np.float32))}}
        jq = jax_q4s(tree, JaxQMCConfig(**QMC), min_dim=16)
        assert isinstance(jq["ffn"]["w_up"], JaxQTensor)
        assert jq["ffn"]["w_up"].in_codes.ndim == 5
        assert jq["attn"]["wq"].in_codes.ndim == 5         # [G, 1, ...]
        flat = jax_tree_to_numpy(jq)
        assert flat["ffn"]["w_up"]["stack"] == "experts"
        assert flat["attn"]["wq"]["stack"] == "shards"
        port = params_from_numpy(flat, device="cpu")
        assert [len(row) for row in port["ffn"]["w_up"]] == [e, e]
        assert [type(q) for q in port["attn"]["wq"]] == [QTensor] * 2
        one = jax.tree_util.tree_map(lambda l: l[1, e - 1],
                                     jq["ffn"]["w_up"])
        np.testing.assert_array_equal(
            dequantize_qtensor(port["ffn"]["w_up"][1][e - 1],
                               torch.float32).numpy(),
            np.asarray(jax_dequantize(one, jnp.float32)))
        del flat["ffn"]["w_up"]["stack"]
        with pytest.raises(ValueError, match="stack"):
            params_from_numpy(flat, device="cpu")


# ---------------------------------------------------------------------------
# the paged engine against the JAX paged engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    """QMC weights (rho 0.3) of reduced dbrx-132b and jamba, quantized by
    the port and crossed over to the JAX package (whose eager PTQ of the
    expert stacks takes far longer)."""
    out = {}
    for arch in ("dbrx-132b", "jamba-1.5-large-398b"):
        cfg = reduced_config(arch)
        q = quantize_for_serving(init_params(cfg, 0, device="cpu"),
                                 QMCConfig(**QMC), min_dim=64)
        out[arch] = (jax_reduced(arch), port_params_to_jax(q), cfg, q)
    return out


def _requests(cls, lane, vocab, n=6):
    rng = np.random.default_rng(11)
    sys_prompt = rng.integers(2, vocab, 16)
    phrase = rng.integers(2, vocab, 4)
    reqs = []
    for i in range(n):
        if lane == "prefix":
            prompt = np.concatenate([sys_prompt, rng.integers(
                2, vocab, int(rng.integers(3, 9)))])
        elif lane == "speculative":
            prompt = np.concatenate([phrase] * 3 + [phrase[:2]])
        else:
            prompt = rng.integers(2, vocab, int(rng.integers(4, 20)))
        sp = None
        if lane == "sampled" and i % 2 == 0:
            sp = (SamplingParams if cls is Request else JaxSamplingParams)(
                temperature=0.8, top_k=16, top_p=0.9, seed=3)
        reqs.append(cls(uid=i, prompt=prompt.astype(np.int32),
                        max_new_tokens=int(rng.integers(4, 10)),
                        sampling=sp))
    return reqs


LANES = {"greedy": {}, "sampled": {}, "speculative": dict(speculative_k=2),
         "prefix": dict(prefix_cache=True)}


@pytest.mark.parametrize("arch,lane", [
    ("dbrx-132b", "greedy"), ("dbrx-132b", "sampled"),
    ("dbrx-132b", "speculative"), ("dbrx-132b", "prefix"),
    ("jamba-1.5-large-398b", "greedy")])
def test_engine_matches_jax_engine(served, arch, lane):
    jcfg, jparams, cfg, params = served[arch]
    assert cfg.capacity_factor == 1.25
    kw = dict(slots=4, max_len=48, page_size=8, **LANES[lane])
    # both engines on the ragged attention kernel route (the port's
    # default; the Pallas kernel in interpret mode for JAX): padding rows
    # come out as zeros there and as attention over the valid keys on the
    # gather route, and they take expert capacity either way
    jeng = JaxEngine(jcfg, jparams, weight_plan=False, paged_attention=True,
                     **kw)
    # on the hybrid stack no slot is reused: a reset of a reseated slot's
    # SSM state can be lost in the JAX engine (ROADMAP.md C)
    n = 4 if arch.startswith("jamba") else 6
    jout = jeng.run(_requests(JaxRequest, lane, cfg.vocab, n))
    eng = ServeEngine(cfg, params, device="cpu", **kw)
    out = eng.run(_requests(Request, lane, cfg.vocab, n))
    assert [r.out_tokens for r in out] == [r.out_tokens for r in jout]
    for field in STATS:
        assert getattr(eng.stats, field) == getattr(jeng.stats, field), \
            field
    if lane == "speculative":
        assert eng.stats.spec_draft_tokens > 0
    if lane == "prefix":
        assert eng.stats.cache_hits + eng.stats.dedup_hits > 0


# ---------------------------------------------------------------------------
# cost attribution
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lanes,c", [(4, 1), (2, 8)])
def test_step_work_counts_moe(tiny_moe, lanes, c):
    """The MoE layers' share of ``step_work``: per group, the router at M
    = lanes * C and E x 3 dense expert products at the call's capacity
    rows, plus the dispatch and combine bytes; the attention and head
    terms are those of the same stack with the FFN removed."""
    cfg = _port_cfg(tiny_moe)
    params = init_params(cfg, 0, device="cpu")
    pool = PagedKVPool(cfg, n_pages=9, page=8, max_slots=lanes,
                       max_pages_per_seq=4, device="cpu")
    arena = pool.init_arena()
    w = step_work(cfg, params, arena, lanes=lanes, c=c)
    m, d, ff, e, k = lanes * c, cfg.d_model, cfg.d_ff, cfg.n_experts, 2
    cap = capacity(m, cfg)
    products = [rl.matmul_work(cap, d, ff, 4, 4)] * (2 * e) \
        + [rl.matmul_work(cap, ff, d, 4, 4)] * e
    moe_b, moe_f = rl.moe_work(m=m, cap=cap, d=d, n_experts=e, topk=k,
                               x_itemsize=4, router_itemsize=4,
                               experts=products)
    assert moe_f == 2.0 * m * d * e + 3 * e * 2.0 * cap * d * ff \
        + 2.0 * m * k * d
    no_ffn = {**params, "blocks": {"b0": {
        n: v for n, v in params["blocks"]["b0"].items() if n != "ffn"}}}
    base = step_work(cfg, no_ffn, arena, lanes=lanes, c=c)
    assert w["flops"] == base["flops"] + cfg.n_groups * moe_f
    assert w["bytes"] == base["bytes"] + cfg.n_groups * moe_b
