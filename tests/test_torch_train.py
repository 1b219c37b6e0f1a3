"""Training on one device: the port (``repro_torch.models.layers.
cross_entropy_loss``, ``models.chunked_ce``, ``models.model.train_loss``,
``optim.adamw``, ``data``, ``checkpoint.ckpt``, ``ft.watchdog``,
``train.step``, ``train.trainer``, ``launch.train``) against the JAX
package on the same inputs, on the CPU.

Tolerances: the three CE losses and their gradients at rtol 1e-5 (fp32,
one matmul summed in another order; the gradients also atol 1e-6 *
max|g|, for entries that are sums cancelling to ~0, as the
``train_loss`` leaves); ``train_loss`` at rtol 1e-5 and each
gradient leaf at rtol 1e-4 / atol 1e-6 * max|g| (a whole fp32 backward
through the stack); AdamW on identical gradients and state at rtol 1e-6
(the same fp32 arithmetic; bf16 moments rounded from it); ``lr_schedule``
at 1e-7; the synthetic corpus bit for bit; a resumed run bit for bit
against an unbroken one (same device, same ops)."""
import dataclasses
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.data.synthetic import CorpusConfig as JaxCorpusConfig
from repro.data.synthetic import SyntheticCorpus as JaxCorpus
from repro.models import chunked_ce as jax_ce
from repro.models.layers import cross_entropy_loss as jax_xent
from repro.models.model import init_params as jax_init
from repro.models.model import train_loss as jax_train_loss
from repro.optim import adamw as jax_adamw
from repro.train.step import _grads_fn as jax_grads_fn
from repro_torch import tree as T
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import ckpt
from repro_torch.configs import reduced_config
from repro_torch.data.loader import PrefetchLoader, host_slice
from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.launch import train as train_cli
from repro_torch.models import chunked_ce
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models.model import train_loss
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as train_step
from repro_torch.train.trainer import TrainConfig, train
from test_torch_bridge import jax_tree_to_numpy

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6       # atol x max|g| of the leaf


def _np(x):
    return np.asarray(jax.device_get(x))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _assert_grads_close(got, want, rtol, atol_frac):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k in got:
        g, w = got[k].detach().numpy(), _np(want[k])
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol_frac * np.abs(w).max(),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------
def _xwl(t=16, d=32, v=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t // 2, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, size=(2, t // 2)).astype(np.int32)
    return x, w, labels


@pytest.mark.parametrize("cap", [None, 5.0])
@pytest.mark.parametrize("kind,v,chunk", [
    ("chunked", 300, 128),      # the last chunk padded (300 = 2 x 128 + 44)
    ("chunked", 256, 128),
    ("chunked", 300, 512),      # one chunk wider than the vocab
    ("sharded", 300, None)])
def test_ce_losses_and_grads_match_jax(kind, v, chunk, cap):
    x, w, labels = _xwl(v=v)
    if kind == "chunked":
        def jfn(x_, w_):
            return jax_ce.chunked_ce_loss(x_, w_, jnp.asarray(labels),
                                          chunk=chunk, logit_softcap=cap)

        def pfn(x_, w_):
            return chunked_ce.chunked_ce_loss(
                x_, w_, torch.from_numpy(labels), chunk=chunk,
                logit_softcap=cap)
    else:
        def jfn(x_, w_):
            return jax_ce.sharded_ce_loss(x_, w_, jnp.asarray(labels),
                                          logit_softcap=cap)

        def pfn(x_, w_):
            return chunked_ce.sharded_ce_loss(
                x_, w_, torch.from_numpy(labels), logit_softcap=cap)
    want, (gx, gw) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = pfn(xt, wt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for g, jg in ((xt.grad, gx), (wt.grad, gw)):
        jg = _np(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=LOSS_RTOL,
                                   atol=GRAD_ATOL * np.abs(jg).max())
    # and all three agree with the plain CE over the full logits
    logits = torch.from_numpy(x) @ torch.from_numpy(w)
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    plain = cross_entropy_loss(logits, torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), plain.item(), rtol=LOSS_RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_jax(masked):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 6, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.6).astype(np.float32) if masked else None
    want, g = jax.value_and_grad(lambda lg: jax_xent(
        lg, jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask)))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = cross_entropy_loss(lt, torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(lt.grad.numpy(), _np(g), rtol=LOSS_RTOL)


def test_chunked_ce_refuses_a_mask_as_the_reference():
    x, w, labels = _xwl()
    with pytest.raises(NotImplementedError):
        chunked_ce.chunked_ce_loss(
            torch.from_numpy(x), torch.from_numpy(w),
            torch.from_numpy(labels), mask=torch.ones(labels.shape))


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------
def _batch(cfg, b=2, s=24, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _models(arch, **repl):
    jcfg = dataclasses.replace(jax_reduced(arch), **repl)
    pcfg = dataclasses.replace(reduced_config(arch), **repl)
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    return jcfg, pcfg, jparams, pparams


@pytest.mark.parametrize("arch,repl", [
    ("stablelm-1.6b", {}),
    ("dbrx-132b", {}),                       # MoE: the aux loss counts
    ("gemma2-2b", {"chunked_ce": True}),     # sharded CE, tied head, caps
])
def test_train_loss_and_grads_match_jax(arch, repl):
    jcfg, pcfg, jparams, pparams = _models(arch, **repl)
    batch = _batch(pcfg)
    (want, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_train_loss(jcfg, p, {k: jnp.asarray(v) for k, v in
                                           batch.items()},
                                 scan_layers=False, remat=False),
        has_aux=True))(jparams)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    got, pm, pg = train_step.grads_fn(pcfg)(pparams, tb)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(pm[k].item(), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if arch == "dbrx-132b":
        assert pm["aux"].item() > 0.5            # the MoE loss was summed
    else:
        assert pm["aux"].item() == 0.0
    _assert_grads_close(pg, jg, GRAD_RTOL, GRAD_ATOL)


def test_microbatched_grads_match_jax():
    """Two microbatches: fp32 gradients, losses and aux averaged, as the
    reference's ``_grads_fn`` scans them."""
    jcfg, pcfg, jparams, pparams = _models("dbrx-132b")
    batch = _batch(pcfg, b=4, s=16)
    jl, jm, jg = jax_grads_fn(jcfg, 2, scan_layers=False)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    pl, pm, pg = train_step.grads_fn(pcfg, 2)(pparams, tb)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(pm["aux"].item(), float(jm["aux"]),
                               rtol=LOSS_RTOL)
    _assert_grads_close(pg, jg, GRAD_RTOL, GRAD_ATOL)


def test_serving_forward_drops_the_aux_and_taps_nothing():
    """``forward`` keeps serving's contract: logits only, no aux sum."""
    from repro_torch.models.model import forward
    _, pcfg, _, pparams = _models("dbrx-132b")
    toks = torch.from_numpy(_batch(pcfg)["tokens"]).long()
    out = forward(pcfg, pparams, toks, use_kernels=False)
    assert isinstance(out, torch.Tensor)
    assert out.shape == (*toks.shape, pcfg.vocab)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _opt_inputs(seed=4):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    params = {"w": arr(16, 32), "b": arr(32),
              "nested": {"x": arr(4, 8, 8), "s": arr(8)}}
    # multiples of 1/64: every partial sum of their squares is exact in
    # fp32, so the global norm (and the clip factor) does not depend on
    # the order XLA and torch sum in, and the update's own arithmetic is
    # what is compared (random gradients' norm: the init test)
    grads = T.map_(lambda p: np.round(arr(*p.shape, scale=0.3) * 64) / 64,
                   params)
    m = T.map_(lambda p: arr(*p.shape, scale=0.05), params)
    v = T.map_(lambda p: np.abs(arr(*p.shape, scale=0.01)), params)
    return params, grads, m, v


@pytest.mark.parametrize("clip", [1.0, 0.0, 100.0])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moments, clip):
    params, grads, m, v = _opt_inputs()
    jcfg = jax_adamw.AdamWConfig(lr=1e-3, moment_dtype=moments,
                                 grad_clip=clip)
    pcfg = AdamWConfig(lr=1e-3, moment_dtype=moments, grad_clip=clip)
    jdt = jnp.dtype(moments)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moments]

    def jtree(t, dt=jnp.float32):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), t)

    def ttree(t, dt=torch.float32):
        return T.map_(lambda a: torch.from_numpy(a).to(dt), t)
    jstate = jax_adamw.OptState(jnp.int32(6), jtree(m, jdt), jtree(v, jdt))
    pstate = adamw.OptState(torch.tensor(6, dtype=torch.int32),
                            ttree(m, tdt), ttree(v, tdt))
    jp, js, jo = jax_adamw.update(jtree(grads), jstate, jtree(params), jcfg,
                                  jnp.float32(0.7))
    pp, ps, po = adamw.update(ttree(grads), pstate, ttree(params), pcfg,
                              torch.tensor(0.7))
    assert int(ps.step) == 7 and ps.step.dtype == torch.int32
    np.testing.assert_allclose(po["grad_norm"].item(), float(
        jo["grad_norm"]), rtol=1e-6)
    for got, want in ((pp, jp), (ps.m, js.m), (ps.v, js.v)):
        got, want = dict(_flat(got)), dict(_flat(want))
        for k in got:
            g = got[k].float().numpy()
            w = np.asarray(jnp.asarray(want[k], jnp.float32))
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)
    assert ps.m["w"].dtype == tdt and pp["w"].dtype == torch.float32
    # decay on matrices only: a zero-gradient bias keeps its value
    zero = T.map_(torch.zeros_like, ttree(grads))
    z0 = adamw.init(ttree(params), pcfg)
    zp, _, _ = adamw.update(zero, z0, ttree(params), pcfg, 1.0)
    assert torch.equal(zp["b"], torch.from_numpy(params["b"]))
    assert not torch.equal(zp["w"], torch.from_numpy(params["w"]))


def test_adamw_init_norm_and_lr_schedule_match_jax():
    params, _, m, _ = _opt_inputs()
    np.testing.assert_allclose(
        adamw.global_norm(T.map_(torch.from_numpy, m)).item(),
        float(jax_adamw.global_norm(m)), rtol=1e-6)
    for moments, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        s = adamw.init(T.map_(torch.from_numpy, params),
                       AdamWConfig(moment_dtype=moments))
        assert int(s.step) == 0
        assert all(t.dtype == dt and not t.any() for t in T.leaves(s.m))
    for kw in (dict(warmup=20, total=200), dict(warmup=5, total=40),
               dict(warmup=0, total=10), dict()):
        for step in (0, 1, 4, 5, 19, 20, 21, 100, 199, 200, 500):
            want = float(jax_adamw.lr_schedule(jnp.int32(step), **kw))
            got = adamw.lr_schedule(torch.tensor(step, dtype=torch.int32),
                                    **kw).item()
            np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
    # the reference trains step 0 at lr 0
    assert adamw.lr_schedule(torch.tensor(0), warmup=20).item() == 0.0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_synthetic_corpus_is_bit_identical_to_jax():
    for cc in (dict(vocab=512, seed=1), dict(vocab=64, seed=7),
               dict(vocab=1000, n_topics=3, branch=5, seed=2)):
        j, p = JaxCorpus(JaxCorpusConfig(**cc)), SyntheticCorpus(
            CorpusConfig(**cc))
        for step, host in ((0, 0), (5, 0), (5, 1), (12345, 3)):
            a = j.sample_batch(4, 33, step=step, host=host)
            b = p.sample_batch(4, 33, step=step, host=host)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        for a, b in zip(j.heldout_ppl_batches(2, 3, 16),
                        p.heldout_ppl_batches(2, 3, 16)):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
        a, b = j.cloze_batch(5, seed=2), p.cloze_batch(5, seed=2)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_loader_yields_steps_in_order():
    seen = []
    loader = PrefetchLoader(lambda s: {"x": np.full(3, s)}, start_step=7)
    try:
        for _ in range(5):
            step, b = next(loader)
            seen.append(step)
            assert (b["x"] == step).all()
    finally:
        loader.close()
    assert seen == [7, 8, 9, 10, 11]
    assert host_slice(8, 4, 2) == slice(4, 6)


# ---------------------------------------------------------------------------
# checkpoints and the watchdog (as tests/test_checkpoint_ft.py)
# ---------------------------------------------------------------------------
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((32, 16), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.tensor(3.5),
                       "h": torch.randn((5, 3), generator=g).to(
                           torch.bfloat16)},
            "opt": adamw.OptState(torch.tensor(4, dtype=torch.int32),
                                  {"a": torch.ones(2)}, {"a": torch.zeros(2)})}


def _assert_trees_equal(a, b):
    ia, ib = list(T.items(a)), list(T.items(b))
    assert [k for k, _ in ia] == [k for k, _ in ib]
    for (k, x), (_, y) in zip(ia, ib):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(t, str(tmp_path), step=7)
    assert ckpt.latest_step(str(tmp_path)) == 7
    like = T.map_(torch.zeros_like, t)
    restored, step = ckpt.restore(like, str(tmp_path))
    assert step == 7
    assert isinstance(restored["opt"], adamw.OptState)
    _assert_trees_equal(restored, t)
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))


def test_latest_pointer_advances(tmp_path):
    t = _tree()
    ckpt.save(t, str(tmp_path), step=1)
    ckpt.save(_tree(1), str(tmp_path), step=2)
    assert ckpt.latest_step(str(tmp_path)) == 2
    like = T.map_(torch.zeros_like, t)
    r, s = ckpt.restore(like, str(tmp_path))
    assert s == 2
    _assert_trees_equal(r, _tree(1))
    r1, s1 = ckpt.restore(like, str(tmp_path), step=1)
    assert s1 == 1
    _assert_trees_equal(r1, t)


def test_async_checkpointer_snapshots_at_the_call(tmp_path):
    t = _tree()
    want = T.map_(torch.clone, t)
    saver = ckpt.AsyncCheckpointer()
    saver.save(t, str(tmp_path), step=5)
    t["a"].add_(1.0)                   # a later in-place write is not saved
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, _ = ckpt.restore(T.map_(torch.zeros_like, t), str(tmp_path))
    _assert_trees_equal(restored, want)


def test_shape_mismatch_rejected(tmp_path):
    t = _tree()
    ckpt.save(t, str(tmp_path), step=1)
    bad = dict(T.map_(torch.zeros_like, t), a=torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(bad, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(t, str(tmp_path / "none"))


def test_watchdog_logs_incident():
    wd = StepWatchdog(deadline_s=0.05, policy="log")
    wd.arm(step=3)
    time.sleep(0.15)
    wd.disarm()
    assert len(wd.incidents) == 1
    assert wd.incidents[0].step == 3
    wd.check()  # log policy: no raise


def test_watchdog_raise_policy():
    wd = StepWatchdog(deadline_s=0.05, policy="raise")
    wd.arm(step=1)
    time.sleep(0.15)
    wd.disarm()
    with pytest.raises(TimeoutError):
        wd.check()


# ---------------------------------------------------------------------------
# the trainer and its CLI (as tests/test_trainer_serve.py)
# ---------------------------------------------------------------------------
CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=64)


def test_train_loss_decreases(tmp_path):
    tc = TrainConfig(steps=40, global_batch=8, seq_len=32, log_every=1000,
                     ckpt_dir=str(tmp_path), ckpt_every=20, warmup=5)
    out = train(CFG, tc, AdamWConfig(lr=2e-3), device="cpu",
                log_fn=lambda s: None)
    hist = out["history"]
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first * 0.9, (first, last)
    assert ckpt.latest_step(str(tmp_path)) == 40
    assert hist[0]["lr"] == 0.0                  # step 0 trains at lr 0


def test_train_microbatches_split_the_batch():
    """Two microbatches give the same losses as one batch, up to the fp32
    order of the gradient sum."""
    runs = [train(CFG, TrainConfig(steps=4, global_batch=4, seq_len=16,
                                   log_every=1000, warmup=1,
                                   microbatches=mb),
                  AdamWConfig(lr=1e-3), device="cpu",
                  log_fn=lambda s: None)["history"] for mb in (1, 2)]
    np.testing.assert_allclose([h["loss"] for h in runs[1]],
                               [h["loss"] for h in runs[0]], rtol=1e-5)


def test_train_resume_continues(tmp_path):
    tc1 = TrainConfig(steps=10, global_batch=4, seq_len=16, log_every=1000,
                      ckpt_dir=str(tmp_path), ckpt_every=5)
    train(CFG, tc1, AdamWConfig(lr=1e-3), device="cpu",
          log_fn=lambda s: None)
    tc2 = TrainConfig(steps=15, global_batch=4, seq_len=16, log_every=1000,
                      ckpt_dir=str(tmp_path), ckpt_every=5, resume=True)
    out2 = train(CFG, tc2, AdamWConfig(lr=1e-3), device="cpu",
                 log_fn=lambda s: None)
    steps = [h["step"] for h in out2["history"]]
    assert steps[0] == 10 and steps[-1] == 14   # resumed at the ckpt step


def test_resumed_run_is_bit_identical_to_an_unbroken_one(tmp_path):
    """10 steps straight against 5 steps, a checkpoint, and 5 resumed
    steps (the first run's step-5 checkpoint alone in a fresh directory):
    parameters and optimizer state bit for bit."""
    full_dir, half_dir = tmp_path / "full", tmp_path / "half"
    tc = dict(steps=10, global_batch=4, seq_len=16, log_every=1000,
              ckpt_every=5, warmup=3)
    out = train(CFG, TrainConfig(ckpt_dir=str(full_dir), **tc),
                AdamWConfig(lr=1e-3), device="cpu", log_fn=lambda s: None)
    half_dir.mkdir()
    shutil.copytree(full_dir / "step_5", half_dir / "step_5")
    (half_dir / "LATEST").write_text("5")
    resumed = train(CFG, TrainConfig(ckpt_dir=str(half_dir), resume=True,
                                     **tc),
                    AdamWConfig(lr=1e-3), device="cpu",
                    log_fn=lambda s: None)
    assert [h["step"] for h in resumed["history"]] == [5, 6, 7, 8, 9]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in out["history"][5:]]
    _assert_trees_equal(resumed["params"], out["params"])
    _assert_trees_equal(resumed["opt"], out["opt"])


def test_train_cli_runs_on_the_cpu_and_refuses_the_mesh(tmp_path, capsys):
    """The CLI on one device; a mesh without a backend exits 2; the
    sharded step asks every stack for a mesh, encoder-decoder and VLM
    stacks too (tests/test_torch_train_mesh*.py run the mesh)."""
    train_cli.main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "2",
                    "--batch", "2", "--seq", "8", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
    assert "final loss=" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 2
    for flag in ("--dp", "--tp"):
        with pytest.raises(SystemExit) as e:
            train_cli.main(["--arch", "stablelm-1.6b", "--reduced", flag,
                            "2", "--device", "cpu"])
        assert e.value.code == 2
        assert "--dist-backend" in capsys.readouterr().err
    for arch in ("whisper-medium", "internvl2-2b"):
        with pytest.raises(ValueError, match="needs a mesh"):
            train_step.build_train_step(reduced_config(arch), AdamWConfig(),
                                        None)
    for cfg in (CFG, reduced_config("hymba-1.5b"),
                reduced_config("mamba2-370m"), reduced_config("dbrx-132b")):
        with pytest.raises(ValueError, match="needs a mesh"):
            train_step.build_train_step(cfg, AdamWConfig(), None)
