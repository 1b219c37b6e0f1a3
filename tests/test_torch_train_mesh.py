"""Sharded training of the port (``train.step.build_train_step`` on a rank
mesh: FSDP on ``data``, TP on ``model``, a pure-DP ``pod`` axis) against
the JAX package's ``build_train_step`` / ``_grads_fn`` jitted on a
one-device (1, 1) mesh, on bridged parameters and the same batch; gloo
ranks spawned on the CPU, each mesh shape once, running every case there
(the rank functions live in ``test_torch_train_ranks.py``, which imports
no JAX).

Cases (``CASES``): a dense stack with attention biases at
``test_torch_mesh_serve.py``'s ``BASE`` sizes, and gemma2's structure
(local/global groups, attention and logit softcaps, a tied scaled
embedding) at the same sizes; each with ``cross_entropy_loss`` and with
``sharded_ce_loss`` (``chunked_ce``), microbatches 1 and 2, remat "full"
and "dots". Shapes (1, 2), (2, 1), (2, 2) and (pod 2, data 1, model 2).

Tolerances: the step-0 gradients, made whole with ``unshard``, at rtol
1e-4 and atol 2e-6 x max|g| of the leaf: ``test_torch_train.py``'s rtol,
and twice its atol, because the port on one device already reaches
0.5-0.9e-6 x max|g| against JAX on these 2- and 4-layer stacks (a whole
fp32 backward summed in another order) and the mesh sums in yet another
order (each head slice's ``wo`` product and each dp half's gradient
apart), measured up to 1.3e-6 x max|g|. The 3 steps' losses and grad
norms at rtol 1e-5. The parameters after 3 steps at rtol 1e-5 and an
absolute ``PARAM_ATOL`` = 0.5 x lr (ROADMAP C, the AdamW hazard): AdamW
moves an entry by lr x m / (sqrt(v) + eps), about lr x g / (|g| + eps)
on the first update, so an entry whose gradient is fp32 noise (the key
bias's, whose exact gradient is zero, since it shifts all of a query's
scores alike; any sum that cancels) moves by up to ~0.1 x lr a step
with |g| ~ 1e-9 < eps = 1e-8, in each run independently; step 0 runs at
lr 0, so two updates part such an entry by up to ~0.4 x lr (measured
0.1 x lr), while an entry updated wrongly or not at all parts by ~lr
or more.

Elastic restart: ``train`` 4 steps at (2, 2), checkpointing at step 2;
that checkpoint alone resumed at (1, 2) and in one process gives the
unbroken run's losses at rtol 1e-5; restoring it into another model's
shapes raises. Then the CLI at ``--dp 2 --tp 2 --dist-backend gloo``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import runtime_context as jax_rctx
from repro.launch import mesh as jax_meshlib
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import init_params as jax_init
from repro.optim import adamw as jax_adamw
from repro.train.step import _grads_fn as jax_grads_fn
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, train
from test_torch_bridge import jax_tree_to_numpy
from test_torch_train_ranks import (BATCH, CASES, DENSE, LR, SEQ, STEPS,
                                    WARMUP, case_cfg, copy_step, make_batch,
                                    mesh_job)

TIMEOUT_S = 180.0
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-6       # atol x max|g| of the leaf
PARAM_RTOL, PARAM_ATOL = 1e-5, 0.5 * LR
SHAPES = [(1, 2), (2, 1), (2, 2), (2, 1, 2)]
CASE_IDS = [c[0] for c in CASES]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _jax_cfg(pcfg) -> JaxModelConfig:
    return JaxModelConfig(**{f.name: getattr(pcfg, f.name)
                             for f in dataclasses.fields(JaxModelConfig)})


@pytest.fixture(scope="module")
def reference():
    """Per case: JAX parameters, their bridged numpy copy, the batch, and
    JAX's step-0 gradients and 3 steps of ``build_train_step`` on a
    one-device (1, 1) mesh."""
    mesh = jax_meshlib.make_mesh((1, 1), ("data", "model"))
    dp = jax_meshlib.dp_axes(mesh)
    out = {}
    for case in CASES:
        pcfg = case_cfg(case)
        jcfg, mb = _jax_cfg(pcfg), case[3]
        jparams = jax_init(jcfg, jax.random.PRNGKey(0))
        batch = make_batch(pcfg)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def grads(p, b, jcfg=jcfg, mb=mb):
            with jax_rctx.use_mesh(mesh, dp):
                return jax_grads_fn(jcfg, mb)(p, b)
        loss0, _, g = jax.jit(grads)(jparams, jbatch)
        ocfg = jax_adamw.AdamWConfig(lr=LR)
        step = jax.jit(jax_build_train_step(
            jcfg, ocfg, mesh, microbatches=mb, warmup=WARMUP,
            total_steps=10)[0])
        p, opt, hist = jparams, jax_adamw.init(jparams, ocfg), []
        for _ in range(STEPS):
            p, opt, m = step(p, opt, jbatch)
            hist.append({k: float(v) for k, v in m.items()})
        out[case[0]] = dict(numpy=jax_tree_to_numpy(jparams), batch=batch,
                            grads=g, loss0=float(loss0), history=hist,
                            params=p)
    return out


@pytest.fixture(scope="module")
def port_runs(reference, tmp_path_factory):
    """Each mesh shape spawned once: every case, and on (2, 2) and (1, 2)
    the elastic restart; then the restart in one process."""
    root = tmp_path_factory.mktemp("elastic")
    params = {c: params_from_numpy(r["numpy"], device="cpu")
              for c, r in reference.items()}
    batches = {c: r["batch"] for c, r in reference.items()}
    cases = {"cases": CASES, "params": params, "batches": batches}
    wrong = dataclasses.replace(DENSE, d_model=32)
    out = {}
    for shape in [(2, 2), (1, 2), (2, 1), (2, 1, 2)]:
        job = dict(cases)
        if shape == (2, 2):
            job["elastic_first"] = (DENSE, str(root / "unbroken"))
        if shape == (1, 2):
            job["elastic_resume"] = (DENSE, copy_step(
                str(root / "unbroken"), str(root / "at_1_2"), 2), wrong)
        out[shape] = spawn(mesh_job, shape, backend="gloo", args=(job,),
                           timeout_s=TIMEOUT_S)
    one = train(DENSE, TrainConfig(
        steps=4, global_batch=BATCH, seq_len=SEQ, log_every=1000,
        ckpt_dir=copy_step(str(root / "unbroken"), str(root / "one"), 2),
        ckpt_every=100, resume=True, warmup=WARMUP), AdamWConfig(lr=LR),
        device="cpu", log_fn=lambda s: None)
    out["one"] = [h["loss"] for h in one["history"]]
    return out


def _ids(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("case", CASE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sharded_grads_match_jax(port_runs, reference, shape, case):
    ref = reference[case]
    for r in port_runs[shape]:
        got = r["cases"][case]
        np.testing.assert_allclose(got["loss0"], ref["loss0"],
                                   rtol=LOSS_RTOL)
        want = dict(_flat(ref["grads"]))
        have = dict(_flat(got["grads"]))
        assert have.keys() == want.keys()
        for k, w in want.items():
            w = np.asarray(w)
            np.testing.assert_allclose(have[k].numpy(), w, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL * np.abs(w).max(),
                                       err_msg=f"{shape} {case} {k}")


@pytest.mark.parametrize("case", CASE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sharded_losses_and_norms_match_jax(port_runs, reference, shape,
                                            case):
    want = reference[case]["history"]
    for r in port_runs[shape]:
        got = r["cases"][case]["history"]
        assert got == port_runs[shape][0]["cases"][case]["history"]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose([h[k] for h in got],
                                       [h[k] for h in want],
                                       rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("case", CASE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sharded_params_after_3_steps_match_jax(port_runs, reference,
                                                shape, case):
    want = dict(_flat(reference[case]["params"]))
    for r in port_runs[shape]:
        have = dict(_flat(r["cases"][case]["params"]))
        for k, w in want.items():
            np.testing.assert_allclose(have[k].numpy(), np.asarray(w),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{shape} {case} {k}")


def test_elastic_restart_onto_another_mesh(port_runs):
    """4 unbroken steps at (2, 2) against the step-2 checkpoint resumed
    at (1, 2) and in one process."""
    unbroken = port_runs[(2, 2)][0]["elastic_first"]
    assert all(r["elastic_first"] == unbroken for r in port_runs[(2, 2)])
    for r in port_runs[(1, 2)]:
        res = r["elastic_resume"]
        assert res["steps"] == [2, 3]
        np.testing.assert_allclose(res["losses"], unbroken[2:],
                                   rtol=LOSS_RTOL)
    np.testing.assert_allclose(port_runs["one"], unbroken[2:],
                               rtol=LOSS_RTOL)


def test_restore_onto_a_mesh_refuses_other_shapes(port_runs):
    for r in port_runs[(1, 2)]:
        assert "shape mismatch" in r["elastic_resume"]["refused"]


def test_train_cli_on_a_mesh(tmp_path, capsys):
    """``--dp 2 --tp 2 --dist-backend gloo`` prints rank 0's final loss,
    that of the run without mesh flags (to fp32 reassociation)."""
    argv = ["--arch", "stablelm-1.6b", "--reduced", "--steps", "3",
            "--batch", "4", "--seq", "8", "--device", "cpu"]
    one = train_cli.main(argv)
    meshed = train_cli.main(argv + ["--dp", "2", "--tp", "2",
                                    "--dist-backend", "gloo",
                                    "--ckpt-dir", str(tmp_path)])
    assert "done on a (2, 2) mesh" in capsys.readouterr().out
    np.testing.assert_allclose(meshed, one, rtol=LOSS_RTOL)
    # rank 0 wrote the whole leaves once
    assert os.listdir(tmp_path / "step_3")
