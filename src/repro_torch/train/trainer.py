"""Training loop: data prefetch, checkpoint/restart, straggler watchdog
(counterpart of ``repro.train.trainer``), on one device or on a rank
mesh.

Fault-tolerance contract, as the reference's:
  * checkpoints are atomic + async (``checkpoint/ckpt.py``) every
    ``ckpt_every`` steps, and once more at the end;
  * on startup, ``resume=True`` restores the latest checkpoint (elastic:
    onto the current mesh, whatever mesh wrote it);
  * a StepWatchdog arms a per-step deadline; policy "raise" aborts so the
    outer launcher restarts from the checkpoint;
  * data is keyed by (seed, host, step): restart replays from the exact
    batch after the checkpoint step.

Parameters come from the port's ``init_params(cfg, seed)`` (the JAX PRNG
init is not reproduced bit for bit; parity with the reference goes
through the weight bridge). The loop runs on the card unless the caller
asks for the CPU (``device="cpu"``). ``microbatches`` splits each batch
for gradient accumulation, as the reference's sharded step does (its
single-device loop does not read it).

With ``mesh`` (a ``launch.mesh.Mesh``; every rank calls ``train``) the
loop runs ``train.step.build_train_step``: every rank initialises the
whole tree from the seed, keeps its slice (``launch.sharding.
train_slices``) and drops the whole tree before the moments are made;
every rank draws the same global batch from ``(seed, step)`` and takes
its dp rows (``sharding.batch_rows``; with ``microbatches``, its share of
each global microbatch, as the reference's step splits the global
batch). An MoE stack on a dp mesh needs a global batch that divides the
dp axes: its capacity and aux are taken over the dp ranks' rows. A
checkpoint holds whole leaves (``sharding.unshard``, written by rank 0),
as the reference's is
unsharded on disk, so a run resumes on any mesh or on one device. Each
rank keeps its own watchdog; rank 0 logs. A rank that raises leaves its
peers blocked in a collective until the group's timeout, so every rank
raises (``launch.mesh.spawn`` ends them all at once). On the card each
history entry also holds the step's peak memory (``peak_bytes``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import build_train_step, single_device_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    global_batch: int = 8
    seq_len: int = 128
    microbatches: int = 1
    ckpt_every: int = 100
    ckpt_dir: Optional[str] = None
    resume: bool = False
    log_every: int = 10
    step_deadline_s: float = 300.0
    watchdog_policy: str = "log"
    warmup: int = 20
    seed: int = 0


def _to_device(batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    """Token ids as int64 (torch's index type), everything else as is."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(dev)
    return out


def train(model_cfg: ModelConfig, train_cfg: TrainConfig,
          opt_cfg: AdamWConfig = AdamWConfig(), mesh=None, *,
          device="cuda", log_fn: Callable[[str], None] = print,
          extra_batch_fn: Optional[Callable] = None) -> Dict:
    """Runs the loop; returns ``{"params", "opt", "history", "corpus",
    "incidents"}`` (on a mesh, ``params`` and ``opt`` are this rank's
    slices). ``extra_batch_fn(global_batch, seq_len, cfg)`` adds the
    global batch's ``frames`` or ``vis_embeds``, whose rows a mesh rank
    takes as it takes the tokens'."""
    dev = resolve_device(device)
    # the step first: a mesh refuses a stack before the whole tree exists
    if mesh is None:
        step_fn = single_device_step(model_cfg, opt_cfg,
                                     warmup=train_cfg.warmup,
                                     total_steps=train_cfg.steps,
                                     microbatches=train_cfg.microbatches)
        rows = slice(None)
    else:
        step_fn = build_train_step(model_cfg, opt_cfg, mesh,
                                   microbatches=train_cfg.microbatches,
                                   warmup=train_cfg.warmup,
                                   total_steps=train_cfg.steps)
        rows = shd.batch_rows(mesh, train_cfg.global_batch,
                              train_cfg.microbatches)
        if (any(model_cfg.moe_slots) and rows == slice(None)
                and meshlib.dp_size(mesh) > 1):
            raise ValueError(
                f"a global batch of {train_cfg.global_batch} does not "
                f"divide the {meshlib.dp_size(mesh)} dp ranks: an MoE "
                f"stack's capacity counts every dp rank's own rows")
        if mesh.rank != 0:
            log_fn = _quiet
    corpus = SyntheticCorpus(CorpusConfig(vocab=model_cfg.vocab,
                                          seed=train_cfg.seed + 1))
    params = init_params(model_cfg, train_cfg.seed, device=dev)
    if mesh is not None:
        params = shd.train_slices(params, mesh, step_fn.specs)
    opt_state = adamw.init(params, opt_cfg)

    start_step = 0
    if train_cfg.resume and train_cfg.ckpt_dir and \
            ckpt_lib.latest_step(train_cfg.ckpt_dir) is not None:
        state_like = {"params": params, "opt": opt_state}
        restored, at = ckpt_lib.restore(
            state_like, train_cfg.ckpt_dir,
            slice_fn=(shd.restore_slicer(mesh, cfg=model_cfg)
                      if mesh is not None else None))
        params, opt_state = restored["params"], restored["opt"]
        start_step = at
        log_fn(f"[trainer] resumed from step {at}")

    def sample(step):
        b = corpus.sample_batch(train_cfg.global_batch, train_cfg.seq_len,
                                step=step)
        if extra_batch_fn:
            b.update(extra_batch_fn(train_cfg.global_batch,
                                    train_cfg.seq_len, model_cfg))
        return {k: v[rows] for k, v in b.items()}

    def save(saver_or_lib, step):
        state = {"params": params, "opt": opt_state}
        if mesh is not None:
            state = shd.unshard(state, mesh, _state_specs(step_fn.specs),
                                keep=mesh.rank == 0)
        if state is not None:
            saver_or_lib.save(state, train_cfg.ckpt_dir, step)

    loader = PrefetchLoader(sample, start_step=start_step)
    saver = ckpt_lib.AsyncCheckpointer()
    watchdog = StepWatchdog(train_cfg.step_deadline_s,
                            train_cfg.watchdog_policy)
    history = []
    try:
        for _ in range(start_step, train_cfg.steps):
            step_idx, batch = next(loader)
            batch = _to_device(batch, dev)
            watchdog.arm(step_idx)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.monotonic()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            watchdog.disarm()
            watchdog.check()
            entry = {"step": step_idx, "time_s": dt, **metrics}
            if dev.type == "cuda":
                entry["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            history.append(entry)
            if step_idx % train_cfg.log_every == 0:
                log_fn(f"[trainer] step {step_idx} "
                       f"loss={metrics['loss']:.4f} "
                       f"gnorm={metrics['grad_norm']:.2e} {dt*1e3:.0f}ms")
            if train_cfg.ckpt_dir and (step_idx + 1) % \
                    train_cfg.ckpt_every == 0:
                save(saver, step_idx + 1)
    finally:
        loader.close()
        watchdog.close()
        saver.wait()

    if train_cfg.ckpt_dir:
        save(ckpt_lib, train_cfg.steps)
    return {"params": params, "opt": opt_state, "history": history,
            "corpus": corpus, "incidents": watchdog.incidents}


def _quiet(msg: str) -> None:
    """A rank other than 0 logs nothing."""


def _state_specs(specs: dict) -> dict:
    """The specs of ``{"params": ..., "opt": OptState}`` from the
    parameters' (the moments share them; the step count is whole)."""
    out = {"opt/step": ()}
    for path, spec in specs.items():
        out[f"params/{path}"] = spec
        out[f"opt/m/{path}"] = spec
        out[f"opt/v/{path}"] = spec
    return out
