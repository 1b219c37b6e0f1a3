"""Sharded training of the port held to itself, and the rank functions
``tests/test_torch_train_mesh.py`` spawns (no JAX here, so spawned ranks
import this module quickly):

  * ``build_train_step`` on a (1, 1) mesh equals ``single_device_step``
    bit for bit over 3 steps (parameters, both moments, metrics) with
    ``remat=False``;
  * ``remat`` with ``remat_policy`` "full" and "dots" gives gradients
    bit-identical to no remat on the CPU, off a mesh and on a (2, 2) mesh
    (where a rematerialised group re-runs its gathers in the backward);
  * the collectives of one step at (2, 2) by kind, counted from the
    model's shape.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import ckpt
from repro_torch.ft import elastic
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import spawn
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as S
from repro_torch.train.trainer import TrainConfig, train

TIMEOUT_S = 120.0
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=64)
# the dense cases carry attention biases (as stablelm and qwen do): each
# model rank adds only its heads' slice of them
DENSE = ModelConfig(name="t", family="dense", qkv_bias=True, **BASE)
# gemma2's structure at BASE's sizes: local/global groups, softcaps, a
# tied and scaled embedding, gelu
GEMMA = ModelConfig(name="tg", family="dense", n_layers=4, d_model=64,
                    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                    vocab=64, pattern=("attn_local", "attn"), window=8,
                    attn_softcap=50.0, logit_softcap=30.0,
                    scale_embed=True, tie_embeddings=True, act="gelu")
CFGS = {"dense": DENSE, "gemma": GEMMA}
# (name, config, chunked_ce, microbatches, remat_policy)
CASES = [("dense-ce-mb1", "dense", False, 1, "full"),
         ("dense-chunked-mb2", "dense", True, 2, "dots"),
         ("gemma-ce-mb2", "gemma", False, 2, "full"),
         ("gemma-chunked-mb1", "gemma", True, 1, "dots")]
BATCH, SEQ, STEPS, LR, WARMUP = 8, 16, 3, 1e-3, 1


def case_cfg(case) -> ModelConfig:
    _, name, chunked, _, policy = case
    return dataclasses.replace(CFGS[name], chunked_ce=chunked,
                               remat_policy=policy)


def make_batch(cfg, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(BATCH, SEQ + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------
def sharded_cases(mesh, cases, params_by_case, batches):
    """Each case on this rank: the step-0 gradients (made whole with
    ``unshard``) and ``STEPS`` steps of ``build_train_step`` (losses,
    grad norms, the whole parameters after them)."""
    out = {}
    for case in cases:
        cfg = case_cfg(case)
        params = params_by_case[case[0]]
        specs = shd.train_specs(params, mesh)
        local = shd.train_slices(params, mesh, specs)
        rows = shd.batch_rows(mesh, BATCH)
        batch = {k: v[rows] for k, v in torch_batch(batches[case[0]]).items()}
        compute = S.mesh_grads_fn(cfg, mesh, case[3])
        loss, _, grads = compute(local, batch)
        oc = AdamWConfig(lr=LR)
        step = S.build_train_step(cfg, oc, mesh, microbatches=case[3],
                                  warmup=WARMUP, total_steps=10)
        opt = adamw.init(local, oc)
        hist = []
        for _ in range(STEPS):
            local, opt, m = step(local, opt, batch)
            hist.append({k: float(v) for k, v in m.items()})
        out[case[0]] = dict(grads=shd.unshard(grads, mesh, specs),
                            loss0=float(loss), history=hist,
                            params=shd.unshard(local, mesh, specs))
    return out


def elastic_first(mesh, cfg, ckpt_dir):
    """An unbroken 4-step run of ``train`` on this mesh, checkpointing
    every 2 steps; its losses."""
    res = train(cfg, TrainConfig(steps=4, global_batch=BATCH, seq_len=SEQ,
                                 log_every=1000, ckpt_dir=ckpt_dir,
                                 ckpt_every=2, warmup=WARMUP),
                AdamWConfig(lr=LR), mesh, device="cpu",
                log_fn=lambda s: None)
    return [h["loss"] for h in res["history"]]


def elastic_resume(mesh, cfg, ckpt_dir, wrong_cfg):
    """``train(resume=True)`` from a checkpoint another mesh wrote; then
    the same checkpoint restored into a tree of another model's shapes,
    which must raise."""
    res = train(cfg, TrainConfig(steps=4, global_batch=BATCH, seq_len=SEQ,
                                 log_every=1000, ckpt_dir=ckpt_dir,
                                 ckpt_every=100, resume=True,
                                 warmup=WARMUP),
                AdamWConfig(lr=LR), mesh, device="cpu",
                log_fn=lambda s: None)
    wrong = shd.train_slices(init_params(wrong_cfg, 0, device="cpu"), mesh)
    like = {"params": wrong, "opt": adamw.init(wrong, AdamWConfig())}
    try:
        elastic.reshard_restore(like, ckpt_dir, mesh, shd.param_spec,
                                step=2)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return dict(steps=[h["step"] for h in res["history"]],
                losses=[h["loss"] for h in res["history"]], refused=refused)


def mesh_job(mesh, job):
    """Every part of a mesh shape's work in one spawn: the JAX cases, the
    elastic runs, the remat and collective-count checks."""
    out = {}
    if "cases" in job:
        out["cases"] = sharded_cases(mesh, job["cases"], job["params"],
                                     job["batches"])
    if "elastic_first" in job:
        out["elastic_first"] = elastic_first(mesh, *job["elastic_first"])
    if "elastic_resume" in job:
        out["elastic_resume"] = elastic_resume(mesh, *job["elastic_resume"])
    if "remat" in job:
        out["remat"] = remat_on_mesh(mesh, *job["remat"])
    if "count" in job:
        out["count"] = step_counts(mesh, *job["count"])
    if "bf16" in job:
        out["bf16"] = bf16_moments(mesh, *job["bf16"])
    if "unit" in job:
        out["unit"] = {key: unit_mesh_equals_one_device(mesh, *args)
                       for key, args in job["unit"].items()}
    return out


def remat_on_mesh(mesh, cfg, params, batch):
    """The step-0 gradients with remat off, "full" and "dots", each made
    whole: whether "full" and "dots" equal no remat bit for bit."""
    specs = shd.train_specs(params, mesh)
    local = shd.train_slices(params, mesh, specs)
    rows = shd.batch_rows(mesh, BATCH)
    batch = {k: v[rows] for k, v in torch_batch(batch).items()}
    got = {}
    for policy in ("off", "full", "dots"):
        c = dataclasses.replace(cfg, remat_policy="full" if policy == "off"
                                else policy)
        _, _, g = S.mesh_grads_fn(c, mesh, remat=policy != "off")(local,
                                                                  batch)
        got[policy] = g
    return {p: all(torch.equal(a, b) for a, b in
                   zip(T.leaves(got[p]), T.leaves(got["off"])))
            for p in ("full", "dots")}


def bf16_moments(mesh, cfg, params, batch):
    """``STEPS`` steps with bf16 AdamW moments on this rank's slices: the
    moments' dtype, the history and the whole parameters after them."""
    specs = shd.train_specs(params, mesh)
    local = shd.train_slices(params, mesh, specs)
    rows = shd.batch_rows(mesh, BATCH)
    batch = {k: v[rows] for k, v in torch_batch(batch).items()}
    oc = AdamWConfig(lr=LR, moment_dtype="bfloat16")
    step = S.build_train_step(cfg, oc, mesh, warmup=WARMUP, total_steps=10)
    opt = adamw.init(local, oc)
    hist = []
    for _ in range(STEPS):
        local, opt, m = step(local, opt, batch)
        hist.append({k: float(v) for k, v in m.items()})
    return dict(dtypes={t.dtype for t in T.leaves((opt.m, opt.v))},
                history=hist, params=shd.unshard(local, mesh, specs))


def step_counts(mesh, cfg, params, batch):
    """The collectives of one ``build_train_step`` step on this rank, by
    kind."""
    local = shd.train_slices(params, mesh)
    rows = shd.batch_rows(mesh, BATCH)
    batch = {k: v[rows] for k, v in torch_batch(batch).items()}
    step = S.build_train_step(cfg, AdamWConfig(), mesh, warmup=WARMUP)
    opt = adamw.init(local, AdamWConfig())
    mesh.reset_counts()
    step(local, opt, batch)
    return {k: v[0] for k, v in mesh.by_kind.items()}


def unit_mesh_equals_one_device(mesh, cfg, params, batch, microbatches):
    """``STEPS`` steps of ``build_train_step(remat=False)`` on this (1,
    1) mesh and of ``single_device_step`` in the same process: whether
    parameters, moments and metrics are equal bit for bit."""
    oc = AdamWConfig(lr=LR)
    batch = torch_batch(batch)
    runs = []
    for step in (S.build_train_step(cfg, oc, mesh, remat=False,
                                    microbatches=microbatches,
                                    warmup=WARMUP, total_steps=10),
                 S.single_device_step(cfg, oc, warmup=WARMUP,
                                      total_steps=10,
                                      microbatches=microbatches)):
        p = shd.train_slices(params, mesh)
        opt = adamw.init(p, oc)
        hist = []
        for _ in range(STEPS):
            p, opt, m = step(p, opt, batch)
            hist.append({k: v.item() for k, v in m.items()})
        runs.append((p, opt, hist))
    (pa, oa, ha), (pb, ob, hb) = runs
    same = all(torch.equal(a, b) for a, b in
               zip(T.leaves((pa, oa)), T.leaves((pb, ob))))
    return dict(same=same, metrics_same=ha == hb, history=ha)


# ---------------------------------------------------------------------------
# tests of the port against itself
# ---------------------------------------------------------------------------
def _params(cfg, seed=0):
    return init_params(cfg, seed, device="cpu")


@pytest.fixture(scope="module")
def unit_runs():
    unit = {(name, mb): (cfg, _params(cfg), make_batch(cfg), mb)
            for name, cfg in CFGS.items() for mb in (1, 2)}
    return spawn(mesh_job, (1, 1), backend="gloo", args=({"unit": unit},),
                 timeout_s=TIMEOUT_S)[0]["unit"]


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("microbatches", [1, 2])
def test_unit_mesh_step_is_the_single_device_step(unit_runs, name,
                                                  microbatches):
    run = unit_runs[(name, microbatches)]
    assert run["same"] and run["metrics_same"]
    assert run["history"][0]["lr"] == 0.0 and run["history"][1]["lr"] > 0


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("name", list(CFGS))
def test_remat_grads_are_bit_identical_off_a_mesh(name, policy):
    cfg = dataclasses.replace(CFGS[name], remat_policy=policy,
                              chunked_ce=name == "gemma")
    params = _params(cfg)
    batch = torch_batch(make_batch(cfg))
    want = S.grads_fn(cfg, 2)(params, batch)
    got = S.grads_fn(cfg, 2, remat=True)(params, batch)
    assert torch.equal(got[0], want[0])
    for a, b in zip(T.leaves(got[2]), T.leaves(want[2])):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def mesh22():
    cfg = DENSE
    params, batch = _params(cfg), make_batch(cfg)
    return spawn(mesh_job, (2, 2), backend="gloo",
                 args=({"remat": (GEMMA, _params(GEMMA), make_batch(GEMMA)),
                        "count": (cfg, params, batch),
                        "bf16": (cfg, params, batch)},),
                 timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_grads_are_bit_identical_on_a_mesh(mesh22, policy):
    assert all(r["remat"][policy] for r in mesh22)


def test_collectives_of_a_step_by_kind(mesh22):
    """(2, 2), remat "full", one microbatch, the dense case (2 layers, 7
    matmul weights a layer, attention biases): gathers 2 x 14 + 2
    (forward and rematerialised backward, + embedding and head),
    reduce-scatters 2 x 7 + 2, TP 2 x 5 + 2 (a layer: 2 forward, 1
    recomputed, 2 backward: the recompute stops after the last tensor the
    backward needs, before ``w_down``'s sum), loss 2 (MAX, one SUM of
    se and gold), metrics 1, gradient sums 2 (``data`` for norms and
    biases, ``model`` for the biases), norm 1."""
    want = {"fsdp_gather": 30, "reduce_scatter": 16, "tp": 12, "loss": 2,
            "metrics": 1, "grad_sum": 2, "norm": 1}
    for r in mesh22:
        assert r["count"] == want


def test_bf16_moments_on_a_mesh(mesh22):
    """bf16 moments stay bf16 on the slices, and 3 steps at (2, 2) give
    one device's losses (rtol 1e-5) and parameters within 0.5 x lr (the
    AdamW hazard: ``test_torch_train_mesh.py``'s PARAM_ATOL)."""
    oc = AdamWConfig(lr=LR, moment_dtype="bfloat16")
    step = S.single_device_step(DENSE, oc, warmup=WARMUP, total_steps=10)
    p = _params(DENSE)
    opt = adamw.init(p, oc)
    batch = torch_batch(make_batch(DENSE))
    hist = []
    for _ in range(STEPS):
        p, opt, m = step(p, opt, batch)
        hist.append(m["loss"].item())
    for r in mesh22:
        got = r["bf16"]
        assert got["dtypes"] == {torch.bfloat16}
        np.testing.assert_allclose([h["loss"] for h in got["history"]],
                                   hist, rtol=1e-5)
        for a, b in zip(T.leaves(got["params"]), T.leaves(p)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0.5 * LR)


class FakeMesh:
    """A (2, 2) rank's view without processes (nothing here may call a
    collective)."""
    axis_names = ("data", "model")
    devices = np.arange(4).reshape(2, 2)
    groups: dict = {}

    def __init__(self, data: int, model: int):
        self.coords = {"data": data, "model": model}

    def index(self, ax):
        return self.coords.get(ax, 0)


def test_train_specs_slices_and_unshard_round_trip():
    """``train_slices`` cuts every leaf by ``param_spec`` with its
    ``data`` entries kept (FSDP), and ``grad_axes`` / ``owns`` name the
    replicated leaves: checked on a fake mesh without processes."""
    mesh = FakeMesh(1, 0)
    params = _params(DENSE)
    specs = shd.train_specs(params, mesh)
    assert specs["blocks/b0/attn/wq"] == (None, "data", "model")
    assert specs["embed/tok"] == ("model", "data")
    assert specs["blocks/b0/attn/bq"] == (None, None)
    local = shd.train_slices(params, mesh, specs)
    wq = params["blocks"]["b0"]["attn"]["wq"]
    assert torch.equal(local["blocks"]["b0"]["attn"]["wq"],
                       wq[:, 32:64, 0:32])
    assert shd.grad_axes("blocks/b0/attn/bq", specs["blocks/b0/attn/bq"],
                         mesh) == ("data", "model")
    assert shd.grad_axes("blocks/b0/norm1", specs["blocks/b0/norm1"],
                         mesh) == ("data",)
    assert shd.grad_axes("blocks/b0/attn/wq", specs["blocks/b0/attn/wq"],
                         mesh) == ()
    # a replicated leaf counts on data rank 0 only
    assert not shd.owns(specs["final_norm"], mesh)
    assert shd.owns(specs["blocks/b0/attn/wq"], mesh)
    assert shd.batch_rows(mesh, 8) == slice(4, 8)
    assert shd.batch_rows(mesh, 7) == slice(None)


def test_microbatches_must_divide_the_rank_rows():
    with pytest.raises(ValueError, match="microbatches"):
        S.grads_fn(DENSE, 3)(_params(DENSE), torch_batch(make_batch(DENSE)))


def test_a_loss_mask_over_dp_ranks_is_refused():
    """The mean of the dp ranks' masked means is not the global masked
    mean, so a masked batch on a mesh with dp > 1 raises."""
    batch = torch_batch(make_batch(DENSE))
    batch["loss_mask"] = torch.ones(batch["tokens"].shape)
    compute = S.mesh_grads_fn(DENSE, FakeMesh(0, 0))
    with pytest.raises(NotImplementedError, match="loss mask"):
        compute(shd.train_slices(_params(DENSE), FakeMesh(0, 0)), batch)


def test_checkpoint_written_whole_restores_sliced(tmp_path):
    """``ckpt.restore(..., slice_fn=)`` cuts each whole leaf on
    disk to a rank's block (a fake (2, 2) rank), and refuses a leaf whose
    slice does not fit."""
    mesh = FakeMesh(0, 1)
    params = _params(DENSE)
    ckpt.save({"params": params}, str(tmp_path), 5)
    like = {"params": shd.train_slices(params, mesh)}
    got, step = ckpt.restore(T.map_(torch.zeros_like, like), str(tmp_path),
                             slice_fn=shd.restore_slicer(mesh))
    assert step == 5
    for a, b in zip(T.leaves(got), T.leaves(like)):
        assert torch.equal(a, b)
    bad = {"params": shd.train_slices(
        _params(dataclasses.replace(DENSE, d_ff=256)), mesh)}
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(bad, str(tmp_path), slice_fn=shd.restore_slicer(mesh))


def copy_step(src: str, dst: str, step: int) -> str:
    """A fresh checkpoint directory holding ``src``'s step alone."""
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, f"step_{step}"),
                    os.path.join(dst, f"step_{step}"))
    with open(os.path.join(dst, "LATEST"), "w") as f:
        f.write(str(step))
    return dst
