"""Training loop on one device: data prefetch, checkpoint/restart,
straggler watchdog (counterpart of ``repro.train.trainer`` without a
mesh).

Fault-tolerance contract, as the reference's:
  * checkpoints are atomic + async (``checkpoint/ckpt.py``) every
    ``ckpt_every`` steps, and once more at the end;
  * on startup, ``resume=True`` restores the latest checkpoint;
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
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import single_device_step


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
          opt_cfg: AdamWConfig = AdamWConfig(), *, device="cuda",
          log_fn: Callable[[str], None] = print,
          extra_batch_fn: Optional[Callable] = None) -> Dict:
    """Runs the loop; returns ``{"params", "opt", "history", "corpus",
    "incidents"}``."""
    dev = resolve_device(device)
    corpus = SyntheticCorpus(CorpusConfig(vocab=model_cfg.vocab,
                                          seed=train_cfg.seed + 1))
    params = init_params(model_cfg, train_cfg.seed, device=dev)
    opt_state = adamw.init(params, opt_cfg)

    start_step = 0
    if train_cfg.resume and train_cfg.ckpt_dir and \
            ckpt_lib.latest_step(train_cfg.ckpt_dir) is not None:
        state_like = {"params": params, "opt": opt_state}
        restored, at = ckpt_lib.restore(state_like, train_cfg.ckpt_dir)
        params, opt_state = restored["params"], restored["opt"]
        start_step = at
        log_fn(f"[trainer] resumed from step {at}")

    step_fn = single_device_step(model_cfg, opt_cfg,
                                 warmup=train_cfg.warmup,
                                 total_steps=train_cfg.steps,
                                 microbatches=train_cfg.microbatches)

    def sample(step):
        b = corpus.sample_batch(train_cfg.global_batch, train_cfg.seq_len,
                                step=step)
        if extra_batch_fn:
            b.update(extra_batch_fn(train_cfg.global_batch,
                                    train_cfg.seq_len, model_cfg))
        return b

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
            t0 = time.monotonic()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            watchdog.disarm()
            watchdog.check()
            history.append({"step": step_idx, "time_s": dt, **metrics})
            if step_idx % train_cfg.log_every == 0:
                log_fn(f"[trainer] step {step_idx} "
                       f"loss={metrics['loss']:.4f} "
                       f"gnorm={metrics['grad_norm']:.2e} {dt*1e3:.0f}ms")
            if train_cfg.ckpt_dir and (step_idx + 1) % \
                    train_cfg.ckpt_every == 0:
                saver.save({"params": params, "opt": opt_state},
                           train_cfg.ckpt_dir, step_idx + 1)
    finally:
        loader.close()
        watchdog.close()
        saver.wait()

    if train_cfg.ckpt_dir:
        ckpt_lib.save({"params": params, "opt": opt_state},
                      train_cfg.ckpt_dir, train_cfg.steps)
    return {"params": params, "opt": opt_state, "history": history,
            "corpus": corpus, "incidents": watchdog.incidents}
