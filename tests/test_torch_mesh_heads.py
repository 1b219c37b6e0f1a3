"""The replicated-dim route and encoder-decoder and VLM stacks on the rank
mesh, against the JAX package: gloo ranks spawned on the CPU, each mesh
shape once (the rank function is
``test_torch_mesh_heads_ranks.heads_job``, which imports no JAX).

Training (``CASES`` there, ``reduced_config`` sizes, vocab 509, which
divides neither 2 nor 4, so the embedding and the head replicate over
``model``): whisper-medium at microbatches 2 (its encoder over 16 frames,
the decoder's cross-attention, all tensor-parallel at ``M`` = 2),
internvl2-2b with its 8 visual tokens, and a hymba-structured stack (a
``hybrid`` and a ``hybrid_local`` block) with 5 heads over 1 KV head,
which do not divide 2, so its attention blocks replicate over ``model``
while its Mamba2 mixer and FFN stay cut. Against JAX's
``_grads_fn`` and ``build_train_step`` jitted on a one-device (1, 1) mesh,
on bridged parameters and the same batch, ``frames`` and ``vis_embeds``
drawn with numpy: step 0's loss and gradients (made whole with
``unshard``) leaf by leaf, 3 steps' losses and grad norms, the parameters
after them; and step 0's gradients against the port's one process. Shapes
(1, 2) and (2, 2).

Serving: the hymba-structured stack through ``ServeEngine(mesh=)`` at
(1, 2) and (2, 2), 6 requests on 4 slots, on the ragged paged-attention
route: tokens equal the port's one process and JAX
``LegacyServeEngine``'s (the reference the hybrid mesh test uses); each
model rank's arena holds every KV head; no ``head`` collective (the vocab
replicates, so the head selects locally) and no sum after the replicated
``wo``.

Elastic restart: the hymba-structured stack trained 4 steps at (2, 2),
checkpointing at step 2; that checkpoint resumed at (1, 2) (the attention
leaves whole over ``model``, cut over ``data`` no more) and in one process
gives the unbroken run's losses at rtol 1e-5.

Tolerances: ``tests/test_torch_train_mesh.py``'s. Step-0 gradients at
rtol 1e-4 and atol 2e-6 x max|g| of the leaf, the hymba-structured stack
at 8e-6 x max|g|, the limit ``tests/test_torch_train_mesh_families.py``
sets for hybrid stacks (a whole fp32 backward through attention and
chunked SSD scans, summed in another order). Measured past the rtol, in
units of max|g|: whisper 0.75e-6 (the port's one process against JAX)
and 0.69e-6 (the meshes), internvl 0.81e-6 and 0.72e-6, the
hymba-structured stack 1.10e-6 and 1.21e-6; a dropped or doubled sum
moves a gradient by its own size. A key bias (``bk``, self- and
cross-attention) has an exact gradient of zero, since it shifts all of a
query's scores alike, so its fp32 values are noise (~1e-9 in both
frameworks, each of its own sign): its atol is taken against max|g| of
the ``wk`` beside it, where a dropped or doubled sum would show at the
size of that gradient. Losses and grad norms at rtol 1e-5;
parameters after 3 steps at rtol 1e-5 and atol 0.5 x lr (the AdamW
hazard, ROADMAP C). The mesh against the port's one process at the same
limits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import runtime_context as jax_rctx
from repro.launch import mesh as jax_meshlib
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import init_params as jax_init
from repro.optim import adamw as jax_adamw
from repro.serve.engine import LegacyServeEngine as JaxLegacyEngine
from repro.serve.engine import Request as JaxRequest
from repro.train.step import _grads_fn as jax_grads_fn
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.launch.mesh import spawn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as S
from repro_torch.train.trainer import TrainConfig, train
from test_torch_bridge import jax_tree_to_numpy
from test_torch_mesh_heads_ranks import (CASES, ENGINE, HYMBA5, case_cfg,
                                         heads_job, make_batch,
                                         serve_requests, torch_batch)
from test_torch_train_ranks import BATCH, LR, SEQ, STEPS, WARMUP, copy_step

TIMEOUT_S = 300.0
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = {"default": 2e-6, HYMBA5: 8e-6}     # x max|g| of the leaf
PARAM_RTOL, PARAM_ATOL = 1e-5, 0.5 * LR
SHAPES = [(1, 2), (2, 2)]
NAMES = [c[0] for c in CASES]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _jax_cfg(pcfg) -> JaxModelConfig:
    return JaxModelConfig(**{f.name: getattr(pcfg, f.name)
                             for f in dataclasses.fields(JaxModelConfig)})


def _ids(shape):
    return "x".join(map(str, shape))


@pytest.fixture(scope="module")
def reference():
    """Per case: JAX parameters, their bridged numpy copy, the batch,
    JAX's step-0 loss and gradients and 3 steps of ``build_train_step``
    on a one-device (1, 1) mesh; and JAX ``LegacyServeEngine``'s tokens
    of the hymba-structured stack."""
    mesh = jax_meshlib.make_mesh((1, 1), ("data", "model"))
    dp = jax_meshlib.dp_axes(mesh)
    out = {}
    for name, _, _, mb in CASES:
        jcfg = _jax_cfg(case_cfg(name))
        jparams = jax_init(jcfg, jax.random.PRNGKey(0))
        batch = make_batch(case_cfg(name))
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
        out[name] = dict(numpy=jax_tree_to_numpy(jparams), batch=batch,
                         grads=g, loss0=float(loss0), history=hist,
                         params=p)
        if name == HYMBA5:
            reqs = serve_requests(jcfg.vocab)
            jr = [JaxRequest(uid=r.uid, prompt=r.prompt,
                             max_new_tokens=r.max_new_tokens) for r in reqs]
            JaxLegacyEngine(jcfg, jparams, slots=ENGINE["slots"],
                            max_len=ENGINE["max_len"]).run(jr)
            out["tokens"] = [r.out_tokens for r in jr]
    return out


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """The port's one process (step 0, the served tokens), then (2, 2)
    (every case, the served stack, the unbroken elastic run), then (1, 2)
    (every case, the served stack, the resumed run), then the resumed
    run in one process."""
    root = tmp_path_factory.mktemp("elastic-heads")
    params = {n: params_from_numpy(reference[n]["numpy"], device="cpu")
              for n in NAMES}
    batches = {n: reference[n]["batch"] for n in NAMES}
    one = {}
    for name, _, _, mb in CASES:
        loss, _, g = S.grads_fn(case_cfg(name), mb)(
            params[name], torch_batch(batches[name]))
        one[name] = dict(loss0=float(loss), grads=g)
    hymba = case_cfg(HYMBA5)
    eng = ServeEngine(hymba, params[HYMBA5], device="cpu",
                      paged_attention=True, **ENGINE)
    reqs = serve_requests(hymba.vocab)
    eng.run(reqs)
    out = {"one": one, "tokens": [r.out_tokens for r in reqs]}
    job = {"cases": NAMES, "params": params, "batches": batches,
           "serve": (hymba, params[HYMBA5])}
    out[(2, 2)] = spawn(heads_job, (2, 2), backend="gloo", args=(dict(
        job, elastic_first=(hymba, str(root / "unbroken"))),),
        timeout_s=TIMEOUT_S)
    wrong = dataclasses.replace(hymba, d_model=64)
    out[(1, 2)] = spawn(heads_job, (1, 2), backend="gloo", args=(dict(
        job, elastic_resume=(hymba, copy_step(
            str(root / "unbroken"), str(root / "at_1_2"), 2), wrong)),),
        timeout_s=TIMEOUT_S)
    resumed = train(hymba, TrainConfig(
        steps=4, global_batch=BATCH, seq_len=SEQ, log_every=1000,
        ckpt_dir=copy_step(str(root / "unbroken"), str(root / "one"), 2),
        ckpt_every=100, resume=True, warmup=WARMUP), AdamWConfig(lr=LR),
        device="cpu", log_fn=lambda s: None)
    out["resumed"] = [h["loss"] for h in resumed["history"]]
    return out


def _close(have, want, atol, key, grads, err):
    """``have`` against ``want`` at ``GRAD_RTOL`` and ``atol`` x max|g| of
    the leaf (of its ``wk`` for a key bias, the module docstring)."""
    scale = grads[key[:-2] + "wk"] if key.endswith("/bk") else want
    np.testing.assert_allclose(np.asarray(have), np.asarray(want),
                               rtol=GRAD_RTOL,
                               atol=atol * np.abs(np.asarray(scale)).max(),
                               err_msg=err)


@pytest.mark.parametrize("case", NAMES)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sharded_grads_match_jax(runs, reference, shape, case):
    ref = reference[case]
    atol = GRAD_ATOL.get(case, GRAD_ATOL["default"])
    want = dict(_flat(ref["grads"]))
    for r in runs[shape]:
        got = r["cases"][case]
        np.testing.assert_allclose(got["loss0"], ref["loss0"],
                                   rtol=LOSS_RTOL)
        have = dict(_flat(got["grads"]))
        assert have.keys() == want.keys()
        for key, w in want.items():
            _close(have[key].numpy(), w, atol, key, want,
                   f"{shape} {case} {key}")


@pytest.mark.parametrize("case", NAMES)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sharded_step0_equals_one_process(runs, shape, case):
    """The mesh adds nothing to the port's own one-process gradients."""
    one = runs["one"][case]
    atol = GRAD_ATOL.get(case, GRAD_ATOL["default"])
    want = {k: v.numpy() for k, v in _flat(one["grads"])}
    for r in runs[shape]:
        got = r["cases"][case]
        np.testing.assert_allclose(got["loss0"], one["loss0"],
                                   rtol=LOSS_RTOL)
        for key, g in _flat(got["grads"]):
            _close(g.numpy(), want[key], atol, key, want,
                   f"{shape} {case} {key}")


@pytest.mark.parametrize("case", NAMES)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sharded_losses_and_norms_match_jax(runs, reference, shape, case):
    want = reference[case]["history"]
    for r in runs[shape]:
        got = r["cases"][case]["history"]
        assert got == runs[shape][0]["cases"][case]["history"]
        for key in ("loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose([h[key] for h in got],
                                       [h[key] for h in want],
                                       rtol=LOSS_RTOL, err_msg=key)


@pytest.mark.parametrize("case", NAMES)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sharded_params_after_3_steps_match_jax(runs, reference, shape,
                                                case):
    want = dict(_flat(reference[case]["params"]))
    for r in runs[shape]:
        have = dict(_flat(r["cases"][case]["params"]))
        for key, w in want.items():
            np.testing.assert_allclose(have[key].numpy(), np.asarray(w),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{shape} {case} {key}")


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_replicated_heads_serve_on_the_mesh(runs, reference, shape):
    """Tokens of every rank equal one process's and JAX's; the arena holds
    all ``n_kv * hd`` = 16 KV columns on every model rank; B1's entry ran
    (over the rank's page slice at D = 2); the only collectives are the
    Mamba2 mixer's ``gather``, the ``tp`` sums after its ``out_proj`` and
    the FFN's ``w_down``, and at D = 2 (its slots split over ``data``) the
    page slices' ``merge``, each attention layer's gather of its lanes'
    ``q | k | v`` (``rows``) and the gather of the lanes' tokens."""
    cfg = case_cfg(HYMBA5)
    assert runs["tokens"] == reference["tokens"]
    for r in runs[shape]:
        s = r["serve"]
        assert s["tokens"] == runs["tokens"]
        assert s["kv_width"] == cfg.n_kv_heads * cfg.head_dim
        entry = "slice" if shape[0] > 1 else "whole"
        assert s["attention_calls"][entry] > 0
        kinds = dict(gather=cfg.n_layers, tp=2 * cfg.n_layers)
        if shape[0] > 1:
            kinds["merge"] = 2 * cfg.n_layers
            kinds["rows"] = cfg.n_layers
            kinds["tokens"] = 1
        assert s["by_kind"] == {k: v * s["rounds"]
                                for k, v in kinds.items()}


def test_elastic_restart_of_replicated_heads(runs):
    """4 unbroken steps at (2, 2) against the step-2 checkpoint resumed at
    (1, 2) and in one process, at rtol 1e-5; the checkpoint restored into
    another model's shapes raises."""
    unbroken = runs[(2, 2)][0]["elastic_first"]
    assert all(r["elastic_first"] == unbroken for r in runs[(2, 2)])
    for r in runs[(1, 2)]:
        res = r["elastic_resume"]
        assert res["steps"] == [2, 3]
        np.testing.assert_allclose(res["losses"], unbroken[2:], rtol=1e-5)
        assert "shape mismatch" in res["refused"]
    np.testing.assert_allclose(runs["resumed"], unbroken[2:], rtol=1e-5)
