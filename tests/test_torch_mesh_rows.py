"""The serving step's batch over the data axis (``launch.sharding.
serve_rows``, the mesh step set's ``rows``): JAX's ``batch_spec`` over
``max_slots``. Where the slots divide the data axis a data rank runs its
lanes through every layer outside attention (and the head), gathers
their ``q | k | v`` for the ragged kernel over its page slice (kind
``rows``), holds only their SSM and conv rows, and gathers the lanes'
tokens (kind ``tokens``); where they do not, every rank runs every lane.

Gloo ranks spawned on the CPU at (2, 1) and (2, 2), one spawn per shape
(the rank function is ``test_torch_mesh_rows_ranks.serve_job``), 4 slots
(2 lanes a data rank) unless a case says otherwise:

  * greedy fp32 and int8 KV, and sampled lanes (threefry draws keyed by
    each lane's own key row), against the JAX engine without a mesh;
  * QMC streams of reduced stablelm-1.6b with 4 prompts of 32 tokens at
    chunk 32: the first round's 128 rows take qmm's column strip, and a
    rank's 64 do too (the plan is the global row count's; alone they
    would take the decode-width kernel), tokens equal JAX's on the same
    streams;
  * the pipelined loop and speculative decode (k = 2) against the JAX
    engine without a mesh, run the same way;
  * reduced mamba2-370m and hymba-1.5b on JAX's weights: a rank's arena
    holds 2 of the 4 slots' SSM and conv rows; tokens equal the JAX
    engine's without a mesh;
  * ``max_slots = 3`` at D = 2 (3 does not divide 2): every lane on every
    rank, no ``rows`` or ``tokens`` gather, tokens equal JAX's;
  * the collectives of a greedy round by kind, counted from the code.

The COW page copy across data ranks under the split runs in
``tests/test_torch_mesh_serve.py`` (its engines have 4 slots too).
A pure-Python test holds ``qmm_plan`` and the kernels' K splits under a
row split to one process's plan.
"""
import dataclasses

import jax
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import init_params as jax_init_params
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import runtime_context as ctx
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import quantize_qtensor
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.kernels import ops as kops
from repro_torch.kernels.qmm import colstrip_splits, decode_splits
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import DryMesh, spawn
from repro_torch.models.config import ModelConfig
from repro_torch.serve.sampling import SamplingParams
from test_torch_bridge import jax_tree_to_numpy, port_params_to_jax
from test_torch_mesh_rows_ranks import ENGINE, requests, serve_job

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=64)
HOT = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=3)
# 4 prompts of 32 tokens, one prefill chunk of 32 each
CHUNK = dict(slots=4, max_len=64, page_size=8, chunk_tokens=32)
TIMEOUT_S = 240.0
SHAPES = [(2, 1), (2, 2)]


def _ids(shape):
    return "x".join(map(str, shape))


class _WaitedPageOps(JaxEngine):
    """JAX's engine, its batched page ops waited on before it goes on.
    Its flush hands ``jnp.asarray(reset_mask)`` to an asynchronous call
    and then clears the numpy buffer, which on the CPU the call may still
    read: a slot's SSM and conv reset is lost at times under load."""

    def _build_steps(self):
        steps = super()._build_steps()
        ops = steps.apply_page_ops
        if ops is None:
            return steps
        return dataclasses.replace(
            steps, apply_page_ops=lambda *a: jax.block_until_ready(ops(*a)))


def _jax_tokens(jcfg, jp, reqs, **engine):
    _WaitedPageOps(jcfg, jp, weight_plan=False, **engine).run(reqs)
    return [r.out_tokens for r in reqs]


def _jreqs(reqs, sampling=None):
    return [JaxRequest(uid=r.uid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens, sampling=sampling)
            for r in reqs]


def _with(reqs, sampling):
    return [dataclasses.replace(r, sampling=sampling) for r in reqs]


@pytest.fixture(scope="module")
def served():
    """Every run's reference tokens, then each shape's spawn."""
    models, runs, want = {}, [], []
    for name, quant in (("t", False), ("t8", True)):
        jcfg = JaxModelConfig(name=name, family="dense",
                              kv_cache_quant=quant, **BASE)
        jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
        pcfg = ModelConfig(name=name, family="dense", kv_cache_quant=quant,
                           **BASE)
        models[name] = dict(cfg=pcfg, params=params_from_numpy(
            jax_tree_to_numpy(jp), device="cpu"))
        reqs = requests(64)
        runs.append(dict(model=name, requests=reqs))
        want.append(_jax_tokens(jcfg, jp, _jreqs(reqs), **ENGINE))
        if name == "t":
            jt = (jcfg, jp)
    # sampled lanes
    reqs = _with(requests(64), HOT)
    runs.append(dict(model="t", requests=reqs))
    want.append(_jax_tokens(*jt, _jreqs(reqs, HOT), **ENGINE))
    # QMC streams, a 128-row first round
    jcfg = jax_reduced("stablelm-1.6b")
    dense = params_from_numpy(jax_tree_to_numpy(jax_init_params(
        jcfg, jax.random.PRNGKey(0))), device="cpu")
    q = quantize_for_serving(dense, QMCConfig(rho=0.3,
                                              granularity="subtile"),
                             min_dim=64)
    models["q"] = dict(cfg=reduced_config("stablelm-1.6b"), params=q)
    reqs = requests(jcfg.vocab, n=4, lengths=[32] * 4)
    runs.append(dict(model="q", engine=CHUNK, requests=reqs))
    want.append(_jax_tokens(jcfg, port_params_to_jax(q), _jreqs(reqs),
                            **CHUNK))
    # 3 slots at D = 2
    reqs = requests(64)
    runs.append(dict(model="t", engine=dict(ENGINE, slots=3),
                     requests=reqs))
    want.append(_jax_tokens(*jt, _jreqs(reqs), **dict(ENGINE, slots=3)))
    # the pipelined loop and speculative decode
    for kw, max_new in ((dict(pipelined=True), 4),
                        (dict(speculative_k=2), 8)):
        reqs = requests(64, max_new=max_new)
        runs.append(dict(model="t", engine=dict(ENGINE, **kw),
                         requests=reqs))
        want.append(_jax_tokens(*jt, _jreqs(reqs), **ENGINE, **kw))
    # SSM and hybrid stacks on JAX's weights
    for arch in ("mamba2-370m", "hymba-1.5b"):
        jcfg = jax_reduced(arch)
        jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
        models[arch] = dict(cfg=reduced_config(arch),
                            params=params_from_numpy(jax_tree_to_numpy(jp),
                                                     device="cpu"))
        reqs = requests(jcfg.vocab)
        runs.append(dict(model=arch, requests=reqs))
        want.append(_jax_tokens(jcfg, jp, _jreqs(reqs), **ENGINE))
    job = {"models": models, "runs": runs}
    out = {"want": want}
    for shape in SHAPES:
        out[shape] = spawn(serve_job, shape, backend="gloo", args=(job,),
                           timeout_s=TIMEOUT_S)
    return out


RUNS = ["fp32", "int8kv", "sampled", "qmc-chunk", "slots3", "pipelined",
        "speculative", "mamba2", "hymba"]


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_tokens_equal_without_a_mesh(served, shape, run):
    """Every rank's tokens equal JAX's engine's without a mesh, run with
    the same options; every rank runs 2 of the 4 lanes, all 3 of 3."""
    i = RUNS.index(run)
    for rank, out in enumerate(served[shape]):
        got = out[i]
        assert got["tokens"] == served["want"][i], (shape, run, rank)
        slots = 3 if run == "slots3" else 4
        lanes = slots if run == "slots3" else slots // shape[0]
        assert got["stats"]["rows_per_rank"] == lanes
        assert (got["rows"] is None) == (run == "slots3")
        if run == "pipelined":
            assert got["stats"]["pipelined_rounds"] > 0
        if run == "speculative":
            assert got["stats"]["spec_rounds"] > 0


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_a_rank_plans_qmm_on_the_global_rows(served, shape):
    """The 128-row round of 4 x 32 prompt tokens: a rank's 64 rows take
    qmm's column strip (one process's route; 64 rows alone take the
    decode-width kernel), and decode rounds the decode-width kernel; at
    M = 2 the 64-row shards of the row-parallel streams (K = 64) take the
    plain version by plan, as they do on one process."""
    for out in served[shape]:
        paths = out[RUNS.index("qmc-chunk")]["paths"]
        assert paths["colstrip"] > 0 and paths["decode"] > 0
        assert (paths["ref"] == 0) == (shape[1] == 1)


@pytest.mark.parametrize("arch", ["mamba2", "hymba"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_a_rank_holds_its_lanes_state_rows(served, shape, arch):
    for rank, out in enumerate(served[shape]):
        got = out[RUNS.index(arch)]
        assert got["state_rows"] == [2], (rank, got["state_rows"])
        assert got["stats"]["page_ops_batched"] > 0


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_collectives_of_a_round_by_kind(served, shape):
    """A greedy round of the 2-layer dense stack on every rank: the page
    slices' merge (2 a layer), the lanes' ``q | k | v`` (1 a layer) and
    the lanes' tokens (1); at M = 2 the ``tp`` sums after ``wo`` and
    ``w_down`` and the embedding's (2 a layer + 1) and the vocab-parallel
    head's max, argmin and softmax sum (3). With 3 slots no ``rows`` and
    no ``tokens``."""
    for out in served[shape]:
        for run, lanes_split in (("fp32", True), ("slots3", False)):
            got = out[RUNS.index(run)]
            want = {"merge": 4}
            if lanes_split:
                want.update(rows=2, tokens=1)
            if shape[1] > 1:
                want.update(tp=5, head=3)
            rounds = got["stats"]["rounds"]
            assert got["by_kind"] == {k: v * rounds
                                      for k, v in want.items()}, run


def test_serve_rows_is_jax_batch_spec():
    """``serve_rows``: data rank ``k``'s lanes ``[k B / D, (k + 1) B /
    D)`` where the slots divide the data axis, None where they do not or
    where D = 1; the arena's SSM and conv rows follow it."""
    cfg = reduced_config("hymba-1.5b")
    for shape, slots, want in (((2, 1), 4, [slice(0, 2), slice(2, 4)]),
                               ((2, 2), 8, [slice(0, 4), slice(4, 8)]),
                               ((2, 1), 3, [None, None]),
                               ((1, 2), 4, [None])):
        for d in range(shape[0]):
            mesh = DryMesh(shape, ("data", "model"), d * shape[1])
            assert shd.serve_rows(mesh, slots) == want[d]
            arena = shd.local_arena(cfg, 16, 8, slots, 4, torch.float32,
                                    "meta", mesh)
            rows = {leaf.shape[1] for g in arena.values() if "mamba" in g
                    for leaf in g["mamba"].values()}
            n = slots if want[d] is None else slots // shape[0]
            assert rows == {n}
            assert all(g["attn"]["block_tbl"].shape[1] == slots
                       for g in arena.values() if "attn" in g)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16, 32, 48, 64, 96, 128])
def test_qmm_plan_under_a_row_split_is_one_process_plan(rows, d):
    """A rank's ``rows`` of ``d * rows`` (the batch's): the route is the
    whole batch's, the rank's rows pad to the route's multiple, and the
    K split the kernel takes is planned on the whole batch's rows."""
    k, n = 2048, 5632
    whole = d * rows
    one = kops.qmm_plan(whole, k, n, (8, 128))
    got = kops.qmm_plan(rows, k, n, (8, 128), plan_m=whole)
    assert got["path"] == one["path"]
    mult = 128 if one["path"] == "colstrip" else 8
    assert got["pad_m"] % mult == 0 and 0 <= got["pad_m"] - rows < mult
    m_split = kops.plan_rows(whole)
    assert m_split == one["pad_m"]
    splits = colstrip_splits if one["path"] == "colstrip" else \
        decode_splits
    assert splits(m_split, k, n) == splits(one["pad_m"], k, n)


def test_qmm_plans_on_the_row_split_of_the_context():
    """Under ``use_mesh(..., split_rows=True)`` over D = 2, ``kops.qmm``
    of a rank's 64 rows counts one process's column-strip route (128
    rows), off it the decode-width route; the plain version's results
    agree to 1e-6 (the CPU's product of 128 padded rows against 64)."""
    gen = torch.Generator().manual_seed(0)
    qt = quantize_qtensor(torch.randn((256, 384), generator=gen) / 16,
                          QMCConfig(rho=0.3, granularity="subtile"))
    x = torch.randn((64, 256), generator=gen)
    mesh = DryMesh((2, 1), ("data", "model"))
    kops.reset_path_counts()
    with ctx.use_mesh(mesh, ("data",), split_rows=True):
        assert ctx.current_row_split() == 2
        split = kops.qmm(x, qt)
    alone = kops.qmm(x, qt)
    assert kops.path_counts == {"decode": 1, "colstrip": 1, "ref": 0}
    torch.testing.assert_close(split, alone, atol=1e-6, rtol=1e-6)
    with ctx.use_mesh(mesh, ("data",)):
        assert ctx.current_row_split() == 1
