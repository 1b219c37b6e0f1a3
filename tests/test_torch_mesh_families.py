"""MoE, SSM and hybrid stacks served on the port's rank mesh
(``ServeEngine(mesh=...)``) against the port without a mesh and the JAX
package, gloo ranks spawned on the CPU, each mesh shape once
(``launch.mesh.spawn`` with a timeout; the rank function is
``test_torch_mesh_families_ranks.family_rank``, which imports no JAX).

  * MoE (``tiny_moe``'s sizes: E = 4, top-2, capacity factor 1.25, QMC
    experts from the port's PTQ) at (1, 2) and (2, 2), fp32 and int8 KV:
    expert parallelism, each rank holding half the expert codes; some
    assignment is dropped on every rank, so a capacity that counted
    other rows would show. Tokens equal the port's without a mesh and
    JAX ``ServeEngine(weight_plan=False, paged_attention=True)`` on the
    same streams (one attention route on both sides: padding rows decide
    drops, ``ROADMAP.md`` C). A round makes exactly one ``moe``
    all_reduce per MoE layer, and no other collective than one
    process's stack needs.
  * grok's structure (8 experts, top-2, attention and logit softcaps) at
    (1, 2), and E = 3 at M = 2, the Megatron fallback (each expert's
    ``w_up`` stream cut into 128 of 256 columns, the dense ``w_down`` by
    rows), against the same two references.
  * Mamba stacks at (1, 2) and (2, 1): one whose ``in_proj`` is a dense
    ``[64, 296]`` leaf, cut into 148 columns a rank, and one whose
    ``in_proj`` is a ``[128, 768]`` stream whose cut tiles (384 columns),
    ``out_proj`` a stream cut by rows; 6 requests on 4 slots, so slots
    are reseated and their state reset on the mesh. Tokens equal the
    port's and JAX ``LegacyServeEngine``'s (the JAX paged engine can lose
    a reset, ``ROADMAP.md`` C); one ``gather`` per mixer a round.
  * A hymba-structured hybrid (``hybrid`` and ``hybrid_local`` blocks) at
    (2, 1) against JAX ``LegacyServeEngine``, 6 requests on 4 slots; a
    jamba-structured stack (attention, mamba and MoE layers) at (2, 2)
    against JAX ``ServeEngine`` on 4 requests (no slot reseated) and the
    port on 8.
  * ``quantize_for_serving(tp_shards=2, only_shard=m)`` expert stacks
    against JAX's ``quantize_for_serving(tp_shards=2)`` experts: codes,
    positions and tags equal, scales at rtol 1e-5 (the PTQ's scales can
    sit an ulp apart, ``test_torch_sharding.py``).
  * The CLI at ``--arch dbrx-132b --data-shards 2 --model-shards 2
    --device cpu --dist-backend gloo`` gives the tokens of the run
    without shard flags; ``--arch whisper-medium`` with shard flags exits
    2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.qconfig import QMCConfig as JaxQMCConfig
from repro.core.serving_quant import quantize_for_serving as jax_q4s
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import init_params as jax_init_params
from repro.serve.engine import LegacyServeEngine as JaxLegacyEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import QTensor
from repro_torch.core.qtensor_sharded import ShardedQTensor
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.launch import serve as port_cli
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import spawn
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_bridge import jax_tree_to_numpy, port_params_to_jax
from test_torch_mesh_families_ranks import (QT_FIELDS, StandInMesh,
                                            family_rank)

QMC = dict(rho=0.3, granularity="subtile")
# 15 usable pages + the null page: 8 a data rank at D = 2
ENGINE = dict(slots=4, max_len=32, page_size=8, n_pages=15)
TIMEOUT_S = 240.0
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128)
MOE = dict(family="moe", n_layers=2, n_experts=4, topk=2,
           moe_pattern=(True,), **SMALL)            # tiny_moe
SSM = dict(family="ssm", n_layers=2, n_heads=0, n_kv_heads=0, head_dim=1,
           d_ff=0, vocab=128, pattern=("mamba",))
# name -> (config keywords, weights: the port's QMC streams or JAX's init)
MODELS = {
    "moe": (MOE, "qmc"),
    "moe8": (dict(MOE, kv_cache_quant=True), "qmc"),
    "grok": (dict(MOE, n_experts=8, attn_softcap=30.0, logit_softcap=30.0),
             "qmc"),
    "e3": (dict(MOE, n_experts=3, d_ff=256), "qmc"),
    # in_proj [64, 296]: dense, cut into 148 columns a rank
    "mamba": (dict(SSM, d_model=64, d_state=16, ssm_headdim=16), "jax"),
    # in_proj [128, 768] and out_proj [256, 128]: streams whose cuts tile
    "mambaq": (dict(SSM, d_model=128, d_state=124, ssm_headdim=32), "qmc"),
    "hymba": (dict(family="hybrid", n_layers=4, pattern=("hybrid",
                                                         "hybrid_local"),
                   window=8, d_state=16, ssm_headdim=16, **SMALL), "jax"),
    "jamba": (dict(family="hybrid", n_layers=4, pattern=("attn", "mamba"),
                   moe_pattern=(False, True), n_experts=4, topk=2,
                   d_state=16, ssm_headdim=16, **SMALL), "qmc"),
}
# name -> (JAX reference engine, requests)
REFERENCE = {"moe": ("paged", 6), "moe8": ("paged", 6),
             "grok": ("paged", 6), "e3": ("paged", 6),
             "mamba": ("legacy", 6), "mambaq": ("legacy", 6),
             "hymba": ("legacy", 6), "jamba": ("paged", 4)}
SHAPES = {(1, 2): ("moe", "moe8", "grok", "e3", "mamba", "mambaq"),
          (2, 2): ("moe", "moe8", "jamba", "jamba8"),
          (2, 1): ("mamba", "mambaq", "hymba")}


def _requests(cls, vocab, n, seed=5, max_new=4):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(2, vocab, size=int(L)).astype(
        np.int32), max_new_tokens=max_new)
        for i, L in enumerate(rng.integers(4, 14, size=n))]


def _run(name):
    """(model, request count) of a run: ``jamba8`` is jamba on 8
    requests."""
    return ("jamba", 8) if name == "jamba8" else (name, REFERENCE[name][1])


@pytest.fixture(scope="module")
def models():
    """Every model's configs (JAX, port) and weights (JAX tree, port
    tree), the same values on both sides."""
    out = {}
    for name, (kw, weights) in MODELS.items():
        jcfg = JaxModelConfig(name=name, **kw)
        cfg = ModelConfig(name=name, **kw)
        if weights == "qmc":
            pq = quantize_for_serving(init_params(cfg, 0, device="cpu"),
                                      QMCConfig(**QMC), min_dim=64)
            jp = port_params_to_jax(pq)
        else:
            jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
            pq = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
        out[name] = (jcfg, jp, cfg, pq)
    return out


@pytest.fixture(scope="module")
def ref(models):
    """Each run's tokens: the port without a mesh, and JAX's paged engine
    on the kernel route or its legacy engine."""
    out = {"port": {}, "jax": {}}
    for run in {r for names in SHAPES.values() for r in names}:
        name, n = _run(run)
        jcfg, jp, cfg, pq = models[name]
        eng = ServeEngine(cfg, pq, device="cpu", **ENGINE)
        out["port"][run] = [r.out_tokens for r in eng.run(
            _requests(Request, cfg.vocab, n))]
        out.setdefault("rounds", {})[run] = eng.stats.rounds
        if run == "jamba8":
            continue
        jr = _requests(JaxRequest, jcfg.vocab, n)
        if REFERENCE[name][0] == "paged":
            JaxEngine(jcfg, jp, weight_plan=False, paged_attention=True,
                      **ENGINE).run(jr)
        else:
            JaxLegacyEngine(jcfg, jp, slots=4, max_len=32).run(jr)
        out["jax"][run] = [r.out_tokens for r in jr]
    return out


@pytest.fixture(scope="module")
def meshed(models):
    """Each shape's ranks, spawned once on first use."""
    cache = {}

    def get(shape):
        if shape not in cache:
            names = SHAPES[shape]
            used = {_run(r)[0] for r in names}
            job = {"device": "cpu",
                   "models": {m: dict(cfg=models[m][2], params=models[m][3])
                              for m in used},
                   "runs": [dict(model=_run(r)[0], engine=ENGINE,
                                 requests=_requests(
                                     Request, models[_run(r)[0]][2].vocab,
                                     _run(r)[1])) for r in names]}
            outs = spawn(family_rank, shape, backend="gloo", args=(job,),
                         timeout_s=TIMEOUT_S)
            assert len(outs) == shape[0] * shape[1]
            cache[shape] = outs
        return cache[shape]
    return get


def _check_tokens(shape, meshed, ref):
    """Every run's tokens on every rank: the port's without a mesh and
    (jamba8 aside) JAX's."""
    outs = meshed(shape)
    for rank, out in enumerate(outs):
        for run, got in zip(SHAPES[shape], out["runs"]):
            assert got["tokens"] == ref["port"][run], (shape, rank, run)
            if run in ref["jax"]:
                assert got["tokens"] == ref["jax"][run], (shape, rank, run)
    return outs


def _layers(cfg, kind=None, moe=None):
    """Layers of a stack whose block kind starts with ``kind`` and whose
    FFN is (or is not) MoE."""
    return cfg.n_groups * sum(
        1 for k, m in zip(cfg.pattern, cfg.moe_slots)
        if (kind is None or k.startswith(kind))
        and (moe is None or m == moe))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_moe_expert_parallel_tokens_drops_and_codes(shape, meshed, ref,
                                                    models):
    outs = _check_tokens(shape, meshed, ref)
    for out in outs:
        assert out["drops"] > 0
        held, whole = out["expert_bytes"]["moe"]
        assert 2 * held == whole
    # the two model ranks hold different experts, together all of them
    cfg, pq = models["moe"][2], models["moe"][3]
    ids = [[i for i, q in enumerate(shd.shard_params(
        pq, StandInMesh(shape, (0, m)))["blocks"]["b0"]["ffn"]["w_up"][0])
        if q is not None] for m in range(2)]
    assert ids == [[0, 1], [2, 3]]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_moe_collectives_a_round(shape, meshed, ref, models):
    """Per round on every rank: one ``moe`` all_reduce per MoE layer (the
    layer's only model-axis sum), one ``tp`` sum per attention layer's
    ``wo`` and one for the vocab-parallel embedding, and at D = 2 (4
    slots: each data rank runs 2 lanes) the page-slice merge's two per
    attention layer, each attention layer's gather of its lanes' ``q | k
    | v`` (``rows``), each MoE layer's sum over the dp ranks' rows
    (``moe_dp``: the capacity is global over them) and the one gather of
    the lanes' tokens (``tokens``); nothing else (the ``lm_head``
    stream's 64-column cut would split a subtile, so the head is whole
    and selects without a collective)."""
    cfg = models["moe"][2]
    head = shd.shard_params(models["moe"][3], StandInMesh(shape, (0, 1)))[
        "lm_head"]
    assert isinstance(head, QTensor) and head.shape == (64, 128)
    for out in meshed(shape):
        for run, got in zip(SHAPES[shape], out["runs"]):
            if run not in ("moe", "moe8"):
                continue
            rounds = got["stats"]["rounds"]
            assert rounds == ref["rounds"][run]
            want = {"moe": _layers(cfg, moe=True) * rounds,
                    "tp": (1 + _layers(cfg, "attn")) * rounds}
            if shape[0] > 1:
                assert got["stats"]["rows_per_rank"] == 2
                want["merge"] = 2 * _layers(cfg, "attn") * rounds
                want["rows"] = _layers(cfg, "attn") * rounds
                want["moe_dp"] = _layers(cfg, moe=True) * rounds
                want["tokens"] = rounds
            assert {k: v for k, v in got["by_kind"].items() if v} == want


def test_grok_structure_and_megatron_fallback_1x2(meshed, ref, models):
    """grok's 8 experts (4 a rank) with both softcaps; E = 3 at M = 2,
    every expert cut: a rank holds its 128-column slice of each ``w_up``
    stream, and a round still makes one ``moe`` sum per layer."""
    outs = _check_tokens((1, 2), meshed, ref)
    for out in outs:
        held, whole = out["expert_bytes"]["grok"]
        assert 2 * held == whole
        held, whole = out["expert_bytes"]["e3"]
        assert 0 < held < whole
        got = out["runs"][SHAPES[(1, 2)].index("e3")]
        assert got["by_kind"]["moe"] == 2 * got["stats"]["rounds"]
    pq = models["e3"][3]
    row = shd.shard_params(pq, StandInMesh((1, 2), (0, 1)))[
        "blocks"]["b0"]["ffn"]["w_up"][0]
    assert [q.shape for q in row] == [(64, 128)] * 3


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=str)
def test_mamba_on_the_mesh(shape, meshed, ref, models):
    """Both mamba stacks; at M = 2 ``in_proj`` is cut (dense: 148 columns
    a rank; the stream: 384, a ShardedQTensor of one held shard) and each
    mixer's gather runs once a round, at M = 1 nothing crosses ``model``;
    every seat queued a state reset into the page ops."""
    outs = _check_tokens(shape, meshed, ref)
    for name in ("mamba", "mambaq"):
        cfg, pq = models[name][2], models[name][3]
        local = shd.shard_params(pq, StandInMesh(shape, (0, 1)))
        leaf = local["blocks"]["b0"]["mamba"]["in_proj"]
        if shape[1] == 1:
            continue
        if name == "mamba":
            assert tuple(leaf.shape) == (cfg.n_groups, 64, 148)
        else:
            assert isinstance(leaf[0], ShardedQTensor)
            assert leaf[0].local(1).shape == (128, 384)
            assert isinstance(pq["blocks"]["b0"]["mamba"]["in_proj"][0],
                              QTensor)
    for out in outs:
        for run, got in zip(SHAPES[shape], out["runs"]):
            if run not in ("mamba", "mambaq"):
                continue
            rounds = got["stats"]["rounds"]
            assert got["stats"]["page_ops_batched"] >= 6
            gathers = got["by_kind"].get("gather", 0)
            assert gathers == (2 * rounds if shape[1] == 2 else 0)


def test_hybrid_2x1(meshed, ref):
    _check_tokens((2, 1), meshed, ref)


def test_jamba_structure_2x2(meshed, ref, models):
    """Attention, mamba and MoE layers; the mesh's collectives a round:
    the MoE layers' sums, the mamba layers' gathers and row sums."""
    outs = _check_tokens((2, 2), meshed, ref)
    cfg = models["jamba"][2]
    for out in outs:
        held, whole = out["expert_bytes"]["jamba"]
        assert 2 * held == whole
        got = out["runs"][SHAPES[(2, 2)].index("jamba8")]
        rounds = got["stats"]["rounds"]
        assert got["by_kind"]["moe"] == _layers(cfg, moe=True) * rounds
        assert got["by_kind"]["gather"] == _layers(cfg, "mamba") * rounds


def test_only_shard_experts_match_jax():
    """A rank's ``only_shard`` conversion of ``[G, E, d, ff]`` experts
    against JAX's ``tp_shards=2`` conversion of the same weights (JAX
    stacks every expert, whole, over ``[G, E]``)."""
    rng = np.random.default_rng(3)
    tree = {"blocks": {"b0": {"ffn": {
        "w_up": rng.standard_normal((1, 4, 64, 128)).astype(np.float32),
        "w_down": rng.standard_normal((1, 4, 128, 128)).astype(
            np.float32)}}}}
    jq = jax_q4s(jax.tree_util.tree_map(jnp.asarray, tree),
                 JaxQMCConfig(**QMC), min_dim=64, tp_shards=2)
    port = params_from_numpy(tree, device="cpu")
    for m in range(2):
        own = quantize_for_serving(port, QMCConfig(**QMC), min_dim=64,
                                   tp_shards=2, only_shard=m)
        for name in ("w_up", "w_down"):
            rows, jleaf = own["blocks"]["b0"]["ffn"][name], \
                jq["blocks"]["b0"]["ffn"][name]
            for g in range(1):
                held = [i for i, q in enumerate(rows[g]) if q is not None]
                assert held == [2 * m, 2 * m + 1]
                for e in held:
                    for f in QT_FIELDS:
                        got = getattr(rows[g][e], f).numpy()
                        want = np.asarray(getattr(jleaf, f)[g, e])
                        if f.startswith("scale"):
                            np.testing.assert_allclose(got, want, rtol=1e-5)
                        else:
                            np.testing.assert_array_equal(
                                got, want.astype(got.dtype))


def test_cli_dbrx_mesh_gives_the_unsharded_tokens():
    argv = ["--device", "cpu", "--arch", "dbrx-132b", "--requests", "4",
            "--new-tokens", "6"]
    flat = port_cli.main(argv)
    want = [r.out_tokens for r in flat.last_requests]
    ranks = port_cli.main(argv + ["--data-shards", "2", "--model-shards",
                                  "2", "--dist-backend", "gloo"])
    assert len(ranks) == 4
    assert all(toks == want for toks in ranks)
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["--device", "cpu", "--arch", "whisper-medium",
                       "--data-shards", "2", "--dist-backend", "gloo"])
    assert exc.value.code == 2
