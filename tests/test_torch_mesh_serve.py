"""Sharded serving of the port (``ServeEngine(mesh=...)``) against the port
without a mesh and the JAX engine without a mesh, at the sizes of
``tests/test_sharded_serve.py``'s ``PARITY_SCRIPT``: gloo ranks spawned on
the CPU at (1, 2), (2, 1) and (2, 2).

Each mesh shape spawns once (``launch.mesh.spawn`` with a timeout, so a
hung collective fails its test) and serves, on every rank: fp32 KV, int8
KV, chunked prefill at 8, and a shared prompt served twice through the
prefix cache whose copy-on-write copy goes from a page of data rank 0 to
a page of data rank 1. Greedy tokens must equal the port's without a mesh
and the JAX engine's, on every rank. The (1, 2) shape adds sampled lanes
(vocab shards gathered for the draw) and greedy logprobs, and the (2, 2)
shape the ``tq`` config on ``tp_shards=2`` streams (each rank takes its
shard) against JAX with ``mesh=(1, 1)`` on the same streams, bridged,
and the pipelined loop and speculative decode, which run unchanged on
the mesh step set. Then the CLI: ``--data-shards 2 --model-shards 2 --device cpu
--dist-backend gloo`` gives the tokens of the run without shard flags,
and the refusals."""
import jax
import numpy as np
import pytest

from repro.launch import mesh as jax_meshlib
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import init_params as jax_init_params
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.launch import serve as port_cli
from repro_torch.launch.mesh import spawn
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.steps import build_paged_steps
from repro_torch.serve.sampling import SamplingParams
from test_torch_bridge import jax_tree_to_numpy, port_params_to_jax

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=64)
TQ = dict(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
          vocab=128)
PAGE = 8
# 15 usable pages + the null page: 8 a data rank at D = 2
ENGINE = dict(slots=4, max_len=32, page_size=PAGE, n_pages=15)
TIMEOUT_S = 240.0


def _requests(cls, vocab, n=4, seed=5, max_new=4):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(2, vocab, size=int(L)).astype(
        np.int32), max_new_tokens=max_new)
        for i, L in enumerate(rng.integers(4, 14, size=n))]


def _cow_requests(cls):
    """Run 1: one 16-token prompt (two full pages, cached at its finish:
    pages 1 and 2). Run 2: two other prompts take pages 3-7, then the
    first prompt again adopts pages 1-2 and copies page 2 (data rank 0)
    on write into a fresh page past 7 (data rank 1)."""
    rng = np.random.default_rng(9)
    shared = rng.integers(2, 64, size=16).astype(np.int32)
    first = [cls(uid=0, prompt=shared.copy(), max_new_tokens=4)]
    second = [cls(uid=1, prompt=rng.integers(2, 64, 13).astype(np.int32),
                  max_new_tokens=4),
              cls(uid=2, prompt=rng.integers(2, 64, 13).astype(np.int32),
                  max_new_tokens=4),
              cls(uid=3, prompt=shared.copy(), max_new_tokens=4)]
    return first, second


SCENARIOS = {       # name -> (model, engine keywords)
    "fp32": ("t", {}),
    "int8kv": ("t8", {}),
    "chunk8": ("t", dict(chunk_tokens=8)),
}


@pytest.fixture(scope="module")
def ref():
    """The weights as numpy trees and every scenario's reference tokens:
    the JAX engine's and the port's, both without a mesh."""
    out = {"models": {}, "jax": {}, "port": {}}
    for name, quant in (("t", False), ("t8", True)):
        jcfg = JaxModelConfig(name=name, family="dense",
                              kv_cache_quant=quant, **BASE)
        pcfg = ModelConfig(name=name, family="dense", kv_cache_quant=quant,
                           **BASE)
        jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
        out["models"][name] = dict(cfg=pcfg,
                                   params_np=jax_tree_to_numpy(jp))
        out[name] = (jcfg, jp, pcfg, params_from_numpy(
            out["models"][name]["params_np"], device="cpu"))
    for scen, (model, kw) in SCENARIOS.items():
        jcfg, jp, pcfg, pp = out[model]
        jr = _requests(JaxRequest, 64)
        JaxEngine(jcfg, jp, weight_plan=False, **ENGINE, **kw).run(jr)
        pr = _requests(Request, 64)
        ServeEngine(pcfg, pp, device="cpu", **ENGINE, **kw).run(pr)
        out["jax"][scen] = [r.out_tokens for r in jr]
        out["port"][scen] = [r.out_tokens for r in pr]
    # the prefix cache across two runs, and where its COW copy went
    jcfg, jp, pcfg, pp = out["t"]
    jeng = JaxEngine(jcfg, jp, weight_plan=False, prefix_cache=True,
                     **ENGINE)
    peng = ServeEngine(pcfg, pp, device="cpu", prefix_cache=True, **ENGINE)
    peng._ensure_pool()
    copies = []
    cow = peng._pool.cow

    def logged(slot, pos):
        res = cow(slot, pos)
        if res:
            copies.append(res)
        return res
    peng._pool.cow = logged
    out["jax"]["cow"], out["port"]["cow"] = [], []
    for jreqs, preqs in zip(_cow_requests(JaxRequest),
                            _cow_requests(Request)):
        jeng.run(jreqs)
        peng.run(preqs)
        out["jax"]["cow"].append([r.out_tokens for r in jreqs])
        out["port"]["cow"].append([r.out_tokens for r in preqs])
    out["cow_copies"] = copies
    # sampled lanes, the port alone
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=3)
    pr = _requests(Request, 64)
    ServeEngine(pcfg, pp, device="cpu", sampling=sp, **ENGINE).run(pr)
    out["port"]["sampled"] = [r.out_tokens for r in pr]
    out["sampling"] = sp
    return out


def _runs(ref):
    """The scenarios every mesh serves: one run each, then the prefix
    cache's two batches on one engine."""
    runs = [dict(model=model, engine=dict(ENGINE, **kw),
                 requests=_requests(Request, 64))
            for model, kw in SCENARIOS.values()]
    runs.append(dict(model="t", engine=dict(ENGINE, prefix_cache=True),
                     batches=list(_cow_requests(Request))))
    return runs


def _serve(shape, ref, extra_runs=(), extra_models=None):
    models = dict(ref["models"], **(extra_models or {}))
    job = {"device": "cpu", "models": models,
           "runs": _runs(ref) + list(extra_runs)}
    outs = spawn(port_cli.mesh_worker, shape, backend="gloo", args=(job,),
                 timeout_s=TIMEOUT_S)
    assert len(outs) == shape[0] * shape[1]
    n = len(SCENARIOS)
    for rank, out in enumerate(outs):
        for i, scen in enumerate(SCENARIOS):
            assert out[i]["tokens"] == ref["port"][scen] \
                == ref["jax"][scen], (rank, scen)
            assert out[i]["collectives"] > 0
        cow = [out[n]["tokens"], out[n + 1]["tokens"]]
        assert cow == ref["port"]["cow"] == ref["jax"]["cow"], rank
        assert out[n + 1]["stats"]["cow_copies"] == len(ref["cow_copies"])
        assert out[n + 1]["stats"]["cache_hits"] >= 1
    return [out[n + 2:] for out in outs]


def test_cow_copy_crosses_data_ranks(ref):
    """The scenario's copy-on-write goes from a page of data rank 0 to
    one of data rank 1 at D = 2 (16 pages, 8 a rank)."""
    assert ref["cow_copies"]
    assert any((src < 8) != (dst < 8) for src, dst in ref["cow_copies"])
    assert ref["port"]["cow"] == ref["jax"]["cow"]


def test_mesh_1x2_greedy_and_sampled_lanes(ref):
    """(1, 2): the vocab-parallel head's tokens on sampled lanes, and its
    greedy logprobs against the port without a mesh (to 1e-5: the rows'
    softmax sums add over the vocab shards in another order)."""
    lp = SamplingParams(logprobs=True)
    pcfg, pp = ref["t"][2], ref["t"][3]
    want = _requests(Request, 64)
    ServeEngine(pcfg, pp, device="cpu", sampling=lp, **ENGINE).run(want)
    extra = [dict(model="t", engine=dict(ENGINE, sampling=ref["sampling"]),
                  requests=_requests(Request, 64)),
             dict(model="t", engine=dict(ENGINE, sampling=lp),
                  requests=_requests(Request, 64))]
    for out in _serve((1, 2), ref, extra):
        assert out[0]["tokens"] == ref["port"]["sampled"]
        assert out[1]["tokens"] == [r.out_tokens for r in want]
        np.testing.assert_allclose(
            np.concatenate([np.asarray(x) for x in out[1]["logprobs"]]),
            np.concatenate([r.out_logprobs for r in want]), rtol=0,
            atol=1e-5)


def test_mesh_2x1_greedy(ref):
    _serve((2, 1), ref)


def test_mesh_2x2_greedy_tq_streams_pipelined_speculative(ref):
    """(2, 2): the base scenarios; tq on tp_shards=2 streams against JAX
    ``mesh=(1, 1)`` on them (bridged; ``test_torch_sharding.py`` holds the
    port's conversion to JAX's); the pipelined loop and speculative
    decode (k = 2) against the port without a mesh."""
    jcfg = JaxModelConfig(name="tq", family="dense", **TQ)
    pcfg_q = ModelConfig(name="tq", family="dense", **TQ)
    pq = quantize_for_serving(
        params_from_numpy(jax_tree_to_numpy(jax_init_params(
            jcfg, jax.random.PRNGKey(0))), device="cpu"),
        QMCConfig(rho=0.3, granularity="subtile"), min_dim=64, tp_shards=2)
    jr = _requests(JaxRequest, 128)
    JaxEngine(jcfg, port_params_to_jax(pq),
              mesh=jax_meshlib.make_mesh((1, 1), ("data", "model")),
              **ENGINE).run(jr)
    tq = {"tq": dict(cfg=pcfg_q, params=pq)}
    pcfg, pp = ref["t"][2], ref["t"][3]
    spec = _requests(Request, 64, max_new=8)
    ServeEngine(pcfg, pp, device="cpu", speculative_k=2, **ENGINE).run(spec)
    extra = [dict(model="tq", engine=ENGINE,
                  requests=_requests(Request, 128)),
             dict(model="t", engine=dict(ENGINE, pipelined=True),
                  requests=_requests(Request, 64)),
             dict(model="t", engine=dict(ENGINE, speculative_k=2),
                  requests=_requests(Request, 64, max_new=8))]
    for out in _serve((2, 2), ref, extra, tq):
        assert out[0]["tokens"] == [r.out_tokens for r in jr]
        # the rank's shards through its qmm plan (wo's 64-row shards do
        # not tile: qmm_plan sends them to "ref", as it sends K = 64)
        assert out[0]["paths"]["decode"] > 0
        assert out[1]["tokens"] == ref["port"]["fp32"]
        assert out[1]["stats"]["pipelined_rounds"] > 0
        assert out[2]["tokens"] == [r.out_tokens for r in spec]
        assert out[2]["stats"]["spec_rounds"] > 0


def test_cli_mesh_gives_the_unsharded_tokens():
    argv = ["--device", "cpu", "--requests", "4", "--new-tokens", "6"]
    flat = port_cli.main(argv)
    want = [r.out_tokens for r in flat.last_requests]
    ranks = port_cli.main(argv + ["--data-shards", "2", "--model-shards",
                                  "2", "--dist-backend", "gloo"])
    assert len(ranks) == 4
    assert all(toks == want for toks in ranks)


class _StandInMesh:
    axis_names = ("data", "model")
    devices = np.empty((2, 2), dtype=object)


def test_mesh_refusals():
    """Encoder-decoder and VLM stacks wait for A12 (iii), the contiguous
    prefill and decode on a mesh, on the mesh step set, as the paged
    engine serves neither (hybrid, SSM and MoE stacks are served:
    ``test_torch_mesh_families.py``; heads that do not divide ``model``
    too: ``test_torch_mesh_heads.py``); a mesh engine runs eagerly; shard
    flags need a backend."""
    pcfg = ModelConfig(name="t", family="dense", **BASE)
    for kw in (dict(family="encdec", is_encdec=True, n_enc_layers=2),
               dict(family="vlm", n_vis_tokens=8)):
        cfg = ModelConfig(name="tx", **kw, **BASE)
        with pytest.raises(NotImplementedError, match=r"A12 \(iii\)"):
            build_paged_steps(cfg, page=8, n_pages=15, max_slots=4,
                              max_pages_per_seq=4, cache_dtype=None,
                              device="cpu", cuda_graphs=False,
                              mesh=_StandInMesh())
        with pytest.raises(NotImplementedError):
            ServeEngine(cfg, {}, device="cpu", cuda_graphs=False,
                        mesh=_StandInMesh())
    with pytest.raises(ValueError, match="cuda_graphs=False"):
        ServeEngine(pcfg, {}, device="cpu", mesh=_StandInMesh())
    with pytest.raises(SystemExit):
        port_cli.main(["--device", "cpu", "--data-shards", "2"])
