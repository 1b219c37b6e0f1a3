"""Sharded training of MoE, SSM and hybrid stacks, the port held to itself,
and the rank function ``tests/test_torch_train_mesh_families.py`` spawns
(no JAX here, so spawned ranks import this module quickly):

  * the training rules on a stand-in (2, 2) rank: the expert stacks under
    expert parallelism and under the Megatron fallback, FSDP on their
    ``d`` dim, the Mamba2 leaves (``conv_w`` cut over ``model``, the
    mixer's scalars replicated), which leaves take a SUM over ``model``
    after the backward pass (the router, not the mixer) and which a rank
    counts in the global norm;
  * ``batch_rows`` with microbatches: each dp rank's share of each global
    chunk;
  * ``check_train_mesh`` accepts every decoder-only stack, hymba-1.5b's
    25 heads, whisper-medium and internvl2-2b at full width, and refuses
    a ``d_ff`` that does not divide ``model``;
  * on a (1, 1) mesh the sharded step of an MoE and of a Mamba2 stack is
    the single-device step bit for bit (one process keeps its code);
  * at (2, 2): the collectives of one step by kind for reduced dbrx-132b
    and mamba2-370m, counted from the models' shapes, and the global norm
    of the ranks' slices equal to the whole gradient's (each expert slice
    and each replicated mixer leaf counted once);
  * an elastic restart of an MoE stack: 4 steps at (2, 2) checkpointed at
    step 2, resumed at (1, 2) and in one process, the losses of the
    unbroken run;
  * the CLI at ``--arch mamba2-370m --reduced --dp 2 --tp 2 --device cpu
    --dist-backend gloo``, and at ``--arch whisper-medium --reduced --tp
    2``, prints the final loss of the run without mesh flags;
  * ``obs.costs.train_step_work``: one process's count by hand, and a
    rank's own work (half the experts under expert parallelism, half of
    every cut projection, the whole replicated router).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import runtime_context as ctx
from repro_torch import tree as T
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shd
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn
from repro_torch.models import moe
from repro_torch.models.model import init_params, train_loss
from repro_torch.obs.costs import train_step_work
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as S
from repro_torch.train.trainer import TrainConfig, train
from test_torch_train_ranks import (BATCH, LR, SEQ, STEPS, WARMUP,
                                    copy_step, elastic_resume, make_batch,
                                    mesh_job, torch_batch)

TIMEOUT_S = 180.0
# (name, arch, overrides of reduced_config, microbatches); capacity factor
# 1.25 everywhere (the configs' own), at which the MoE cases drop
# assignments. jamba is cut to one group of its 8-layer pattern
# (attention, 7 Mamba2 layers, MoE on every other FFN)
CASES = [("dbrx-ep-mb1", "dbrx-132b", {}, 1),
         ("dbrx-ep-mb2", "dbrx-132b", {}, 2),
         ("dbrx-fallback-mb2", "dbrx-132b", {"n_experts": 3}, 2),
         ("mamba2-mb2", "mamba2-370m", {}, 2),
         ("hymba-mb1", "hymba-1.5b", {}, 1),
         ("jamba-mb2", "jamba-1.5-large-398b", {"n_layers": 8}, 2)]


def case_cfg(case):
    _, arch, repl, _ = case
    return dataclasses.replace(reduced_config(arch), capacity_factor=1.25,
                               **repl)


def routes(cfg, params, batch, microbatches, mesh=None, specs=None):
    """Every ``moe_block`` call's routing (``moe.record_routes``) in one
    forward per microbatch of ``batch``, without gradients: one process,
    or on ``mesh`` this rank's slices and rows."""
    n = batch["tokens"].shape[0] // microbatches
    gather = shd.fsdp_gather(specs, mesh) if mesh is not None else None
    with torch.no_grad(), moe.record_routes() as out:
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            if mesh is None:
                train_loss(cfg, params, mb, remat=False)
                continue
            with ctx.use_mesh(mesh, meshlib.dp_axes(mesh), split_rows=True):
                train_loss(cfg, params, mb, remat=False, gather=gather)
    return out


def family_cases(mesh, cases, params_by_case, batches):
    """Each case on this rank: its routing (the rows it holds of each
    ``moe_block`` call), the step-0 loss, aux and gradients (made whole
    with ``unshard``) and ``STEPS`` steps of ``build_train_step`` (the
    metrics, the whole parameters after them)."""
    out = {}
    for case in cases:
        cfg, mb = case_cfg(case), case[3]
        params = params_by_case[case[0]]
        specs = shd.train_specs(params, mesh)
        local = shd.train_slices(params, mesh, specs)
        rows = shd.batch_rows(mesh, BATCH, mb)
        batch = {k: v[rows] for k, v in torch_batch(batches[case[0]]).items()}
        got = dict(dp=(meshlib.dp_index(mesh), meshlib.dp_size(mesh)),
                   routes=routes(cfg, local, batch, mb, mesh, specs))
        loss, metrics, grads = S.mesh_grads_fn(cfg, mesh, mb)(local, batch)
        step = S.build_train_step(cfg, AdamWConfig(lr=LR), mesh,
                                  microbatches=mb, warmup=WARMUP,
                                  total_steps=10)
        opt = adamw.init(local, AdamWConfig(lr=LR))
        hist = []
        for _ in range(STEPS):
            local, opt, m = step(local, opt, batch)
            hist.append({k: float(v) for k, v in m.items()})
        got.update(loss0=float(loss), aux0=float(metrics["aux"]),
                   grads=shd.unshard(grads, mesh, specs), history=hist,
                   params=shd.unshard(local, mesh, specs))
        out[case[0]] = got
    return out


def step_counts(mesh, cfg, params, batch):
    """The collectives of one ``build_train_step`` step on this rank by
    kind, and the mesh's global norm of the step-0 gradients against the
    norm of the whole gradients they make up."""
    specs = shd.train_specs(params, mesh)
    local = shd.train_slices(params, mesh, specs)
    batch = {k: v[shd.batch_rows(mesh, BATCH)]
             for k, v in torch_batch(batch).items()}
    step = S.build_train_step(cfg, AdamWConfig(), mesh, warmup=WARMUP)
    opt = adamw.init(local, AdamWConfig())
    mesh.reset_counts()
    step(local, opt, batch)
    kinds = {k: v[0] for k, v in mesh.by_kind.items()}
    _, _, grads = S.mesh_grads_fn(cfg, mesh)(local, batch)
    owned = [shd.owns(specs[p], mesh) for p, _ in T.items(grads)]
    norm = float(adamw.global_norm(grads, mesh, owned))
    whole = float(adamw.global_norm(shd.unshard(grads, mesh, specs)))
    return dict(kinds=kinds, norm=norm, whole_norm=whole)


def elastic_first(mesh, cfg, ckpt_dir):
    res = train(cfg, TrainConfig(steps=4, global_batch=BATCH, seq_len=SEQ,
                                 log_every=1000, ckpt_dir=ckpt_dir,
                                 ckpt_every=2, warmup=WARMUP),
                AdamWConfig(lr=LR), mesh, device="cpu",
                log_fn=lambda s: None)
    return [h["loss"] for h in res["history"]]


def family_job(mesh, job):
    """Every part of a mesh shape's work in one spawn."""
    out = {}
    if "cases" in job:
        out["cases"] = family_cases(mesh, job["cases"], job["params"],
                                    job["batches"])
    if "count" in job:
        out["count"] = {name: step_counts(mesh, *args)
                        for name, args in job["count"].items()}
    if "elastic_first" in job:
        out["elastic_first"] = elastic_first(mesh, *job["elastic_first"])
    if "elastic_resume" in job:
        out["elastic_resume"] = elastic_resume(mesh, *job["elastic_resume"])
    return out


# ---------------------------------------------------------------------------
# the rules on a stand-in rank
# ---------------------------------------------------------------------------
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


def _cfg(name):
    return case_cfg(next(c for c in CASES if c[0] == name))


def test_expert_and_mamba_training_specs():
    mesh = FakeMesh(1, 1)
    specs = shd.train_specs(init_params(_cfg("jamba-mb2"), 0,
                                        device="meta"), mesh)
    ep = specs["blocks/b1/ffn/w_up"]
    assert ep == (None, "model", "data", None)       # EP: 4 experts / 2
    assert specs["blocks/b1/ffn/w_down"] == (None, "model", None, "data")
    assert specs["blocks/b1/ffn/router"] == (None, "data", None)
    assert specs["blocks/b1/mamba/in_proj"] == (None, "data", "model")
    assert specs["blocks/b1/mamba/conv_w"] == (None, "model", None)
    assert specs["blocks/b1/mamba/out_proj"] == (None, "model", "data")
    assert specs["blocks/b1/mamba/a_log"] == (None, None)
    fb = shd.train_specs(init_params(_cfg("dbrx-fallback-mb2"), 0,
                                     device="meta"), mesh)
    assert fb["blocks/b0/ffn/w_gate"] == (None, None, "data", "model")
    assert fb["blocks/b0/ffn/w_down"] == (None, None, "model", "data")
    # the router's gradient is partial over model, the mixer's is not
    for path, want in (("blocks/b1/ffn/router", ("model",)),
                       ("blocks/b1/mamba/a_log", ("data",)),
                       ("blocks/b1/mamba/norm_scale", ("data",)),
                       ("blocks/b1/mamba/conv_w", ("data",)),
                       ("blocks/b1/ffn/w_up", ())):
        assert shd.grad_axes(path, specs[path], mesh) == want, path
    # counted once over the grid: the mixer's scalars on rank (0, 0), the
    # conv's channels on data rank 0, the experts on every rank
    at = {(d, m): FakeMesh(d, m) for d in (0, 1) for m in (0, 1)}
    for path, owners in (("blocks/b1/mamba/a_log", [(0, 0)]),
                         ("blocks/b1/mamba/conv_w", [(0, 0), (0, 1)]),
                         ("blocks/b1/ffn/router", [(0, 0), (1, 0)]),
                         ("blocks/b1/ffn/w_up", list(at))):
        assert [k for k, m in at.items()
                if shd.owns(specs[path], m)] == owners, path
    local = shd.train_slices(init_params(_cfg("jamba-mb2"), 0,
                                         device="cpu"), mesh, specs)
    assert tuple(local["blocks"]["b1"]["ffn"]["w_up"].shape) == (1, 2, 64,
                                                                 256)


def test_batch_rows_with_microbatches():
    """Rank (d, m) of a (2, 2) mesh holds its half of each global chunk:
    rows [0, 8) in 2 microbatches are chunks [0, 4) and [4, 8)."""
    assert shd.batch_rows(FakeMesh(0, 1), 8, 2) == [0, 1, 4, 5]
    assert shd.batch_rows(FakeMesh(1, 0), 8, 2) == [2, 3, 6, 7]
    assert shd.batch_rows(FakeMesh(1, 0), 8, 1) == slice(4, 8)
    assert shd.batch_rows(FakeMesh(1, 0), 8, 4) == [1, 3, 5, 7]
    assert shd.batch_rows(FakeMesh(1, 0), 7, 2) == slice(None)


def test_check_train_mesh_accepts_decoder_only_and_refuses_the_rest():
    """Every stack trains on the mesh, heads and vocabs that do not divide
    ``model`` included (they replicate); only a ``d_ff`` that does not
    divide it is refused."""
    mesh = FakeMesh(0, 0)
    for arch in ("dbrx-132b", "mamba2-370m", "hymba-1.5b",
                 "jamba-1.5-large-398b"):
        shd.check_train_mesh(reduced_config(arch), mesh)
    for arch in ("mamba2-370m", "hymba-1.5b", "whisper-medium",
                 "internvl2-2b"):
        shd.check_train_mesh(get_config(arch), mesh)
    with pytest.raises(ValueError, match="d_ff = 5505"):
        shd.check_train_mesh(dataclasses.replace(get_config("hymba-1.5b"),
                                                 d_ff=5505), mesh)


def test_recorded_routes_of_one_process():
    """``record_routes`` gives each call's top-k ids, its kept mask (the
    first ``cap`` assignments of each expert in (token, choice) order)
    and a positive smallest top-k margin."""
    cfg = _cfg("dbrx-ep-mb1")
    batch = torch_batch(make_batch(cfg))
    got = routes(cfg, init_params(cfg, 0, device="cpu"), batch, 1)
    assert len(got) == cfg.n_layers
    cap = moe.capacity(BATCH * SEQ, cfg)
    dropped = 0
    for r in got:
        ids, kept = r["ids"].reshape(-1), r["kept"].reshape(-1)
        for e in range(cfg.n_experts):
            mine = kept[ids == e]
            assert mine.sum() == min(cap, mine.numel())
            assert mine[:min(cap, mine.numel())].all()
        dropped += int((~kept).sum())
        assert r["margin"] > 0
    assert dropped > 0


def test_train_step_work_counts_a_ranks_own_matmuls():
    """Reduced dbrx (d 128, 4/2 heads of 32, 4 experts top-2 of d_ff 256,
    vocab 512, 2 layers) over 128 tokens: one process's forward by hand;
    a (2, 2) rank counts half of it but the router, which every model
    rank runs whole; a mamba2 rank half of everything (in_proj, out_proj
    and the tied head all cut over model). The step: forward, backward
    twice, the groups' recompute once."""
    cfg, t = _cfg("dbrx-ep-mb1"), 128
    cap = moe.capacity(t, cfg)                         # 80 rows an expert
    layer = (2 * t * 128 * (128 + 64 + 64 + 128)       # wq, wk, wv, wo
             + 2 * t * 128 * 4                         # router
             + 4 * 3 * 2 * cap * 128 * 256)            # experts
    head = 2 * t * 128 * 512
    one = train_step_work(cfg, tokens=t)
    assert one["forward_flops"] == 2 * layer + head
    assert one["flops"] == 4 * 2 * layer + 3 * head
    router = 2 * 2 * t * 128 * 4
    for mesh in (FakeMesh(0, 1), FakeMesh(1, 0)):
        got = train_step_work(cfg, mesh, tokens=t)["forward_flops"]
        assert got == (one["forward_flops"] - router) / 2 + router
    fb = _cfg("dbrx-fallback-mb2")
    assert train_step_work(fb, FakeMesh(0, 0), tokens=t)["forward_flops"] \
        == (train_step_work(fb, tokens=t)["forward_flops"]
            - 2 * 2 * t * 128 * 3) / 2 + 2 * 2 * t * 128 * 3
    ssm = _cfg("mamba2-mb2")
    assert train_step_work(ssm, FakeMesh(0, 1), tokens=t) == {
        k: v / 2 for k, v in train_step_work(ssm, tokens=t).items()}


def test_a_replicated_batch_of_an_moe_stack_is_refused():
    """An MoE stack's capacity counts every dp rank's own rows, so the
    trainer refuses a global batch that does not divide the dp axes."""
    with pytest.raises(ValueError, match="does not divide"):
        train(_cfg("dbrx-ep-mb1"), TrainConfig(steps=1, global_batch=3,
                                               seq_len=8),
              mesh=FakeMesh(0, 0), device="cpu")


# ---------------------------------------------------------------------------
# spawned meshes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def unit_runs():
    unit = {}
    for name in ("dbrx-ep-mb2", "mamba2-mb2"):
        cfg = _cfg(name)
        unit[name] = (cfg, init_params(cfg, 0, device="cpu"),
                      make_batch(cfg), 2)
    return spawn(mesh_job, (1, 1), backend="gloo", args=({"unit": unit},),
                 timeout_s=TIMEOUT_S)[0]["unit"]


@pytest.mark.parametrize("name", ["dbrx-ep-mb2", "mamba2-mb2"])
def test_unit_mesh_step_is_the_single_device_step(unit_runs, name):
    run = unit_runs[name]
    assert run["same"] and run["metrics_same"]
    assert run["history"][0]["lr"] == 0.0


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """(2, 2): the step counts and the unbroken elastic run; then (1, 2)
    resuming from its step-2 checkpoint; then one process."""
    root = tmp_path_factory.mktemp("elastic-moe")
    dbrx, mamba = _cfg("dbrx-ep-mb1"), _cfg("mamba2-mb2")
    count = {name: (cfg, init_params(cfg, 0, device="cpu"),
                    make_batch(cfg)) for name, cfg in (("dbrx", dbrx),
                                                       ("mamba2", mamba))}
    out = {(2, 2): spawn(family_job, (2, 2), backend="gloo", args=(dict(
        count=count, elastic_first=(dbrx, str(root / "unbroken"))),),
        timeout_s=TIMEOUT_S)}
    wrong = dataclasses.replace(dbrx, d_ff=128)
    out[(1, 2)] = spawn(family_job, (1, 2), backend="gloo", args=(dict(
        elastic_resume=(dbrx, copy_step(str(root / "unbroken"),
                                        str(root / "at_1_2"), 2), wrong)),),
        timeout_s=TIMEOUT_S)
    one = train(dbrx, TrainConfig(
        steps=4, global_batch=BATCH, seq_len=SEQ, log_every=1000,
        ckpt_dir=copy_step(str(root / "unbroken"), str(root / "one"), 2),
        ckpt_every=100, resume=True, warmup=WARMUP), AdamWConfig(lr=LR),
        device="cpu", log_fn=lambda s: None)
    out["one"] = [h["loss"] for h in one["history"]]
    return out


def test_collectives_of_a_step_by_kind(meshes):
    """(2, 2), remat "full", one microbatch, 2 layers each.

    dbrx (attention and an MoE FFN a layer, 2 of the 4 experts a rank):
    8 leaves a layer cut over data (wq, wk, wv, wo, router, w_gate,
    w_up, w_down), gathered in the forward and again in the
    rematerialised backward, + the embedding and the head: 34 gathers
    and 2 x 8 + 2 reduce-scatters; TP 2 x 4 + 2 (a layer: the wo sum
    forward and recomputed, the attention's and the MoE block's
    ``tp_input`` sums backward; + the embedding's sum and the head's
    ``tp_input``); ``moe`` 2 (a layer's sum; the recompute stops before
    it) and ``moe_dp`` 2 x 2 (a layer's, recomputed); loss 2, metrics 1,
    gradient sums 2 (``data`` for the norms, ``model`` for the router),
    norm 1.

    mamba2 (a Mamba2 mixer a layer, tied head): 2 leaves a layer cut over
    data (in_proj, out_proj), twice, + the embedding for the lookup and
    for the head: 10 gathers and 2 x 2 + 2 reduce-scatters; ``gather``
    2 x 2 x 2 (the in_proj output and conv_w, forward and recomputed);
    ``split`` 2 (the backward gather of a layer's dy); TP 2 x 2 + 2 (a
    layer: the out_proj sum forward, the ``tp_input`` sum backward; the
    recompute stops before the out_proj sum); loss 2, metrics 1, one
    gradient sum (``data``: the norms, conv_w and the mixer's scalars;
    nothing over ``model``), norm 1."""
    want = {"dbrx": {"fsdp_gather": 34, "reduce_scatter": 18, "tp": 10,
                     "moe": 2, "moe_dp": 4, "loss": 2, "metrics": 1,
                     "grad_sum": 2, "norm": 1},
            "mamba2": {"fsdp_gather": 10, "reduce_scatter": 6, "tp": 6,
                       "gather": 8, "split": 2, "loss": 2, "metrics": 1,
                       "grad_sum": 1, "norm": 1}}
    for r in meshes[(2, 2)]:
        for name, kinds in want.items():
            assert r["count"][name]["kinds"] == kinds, name


def test_global_norm_counts_every_slice_once(meshes):
    """The mesh's norm of the ranks' slices (``owns``) is the norm of the
    whole gradients they make up: each expert slice, the router and the
    mixer's replicated leaves counted once."""
    for r in meshes[(2, 2)]:
        for name, c in r["count"].items():
            np.testing.assert_allclose(c["norm"], c["whole_norm"],
                                       rtol=1e-6, err_msg=name)


def test_elastic_restart_of_an_moe_stack(meshes):
    """4 unbroken steps at (2, 2) against the step-2 checkpoint resumed at
    (1, 2) and in one process, at rtol 1e-5; the checkpoint restored into
    another model's shapes raises."""
    unbroken = meshes[(2, 2)][0]["elastic_first"]
    assert all(r["elastic_first"] == unbroken for r in meshes[(2, 2)])
    for r in meshes[(1, 2)]:
        res = r["elastic_resume"]
        assert res["steps"] == [2, 3]
        np.testing.assert_allclose(res["losses"], unbroken[2:], rtol=1e-5)
        assert "shape mismatch" in res["refused"]
    np.testing.assert_allclose(meshes["one"], unbroken[2:], rtol=1e-5)


def test_train_cli_trains_mamba2_on_a_mesh(capsys):
    """``--arch mamba2-370m --reduced --dp 2 --tp 2`` prints rank 0's
    final loss, that of the run without mesh flags (fp32 reassociation);
    so does whisper-medium (its encoder and cross-attention
    tensor-parallel, its 512-token vocab cut) with ``--tp 2``."""
    for arch, mesh in (("mamba2-370m", ["--dp", "2", "--tp", "2"]),
                       ("whisper-medium", ["--tp", "2"])):
        argv = ["--arch", arch, "--reduced", "--steps", "3", "--batch",
                "4", "--seq", "8", "--device", "cpu"]
        one = train_cli.main(argv)
        meshed = train_cli.main(argv + mesh + ["--dist-backend", "gloo"])
        shape = f"({mesh[1] if mesh[0] == '--dp' else 1}, 2)"
        assert f"done on a {shape} mesh" in capsys.readouterr().out
        np.testing.assert_allclose(meshed, one, rtol=1e-5)
