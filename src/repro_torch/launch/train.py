"""Training CLI of the port (counterpart of ``repro.launch.train``):
random-init weights from ``--seed``, the synthetic corpus, AdamW, atomic
async checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt --resume

Runs on the card (``--device cuda``, the default) or, asked, on the CPU
(``--device cpu``). On restart after a crash or kill, ``--resume`` picks
up from the newest checkpoint. The mesh flags (``--dp``, ``--tp``) are
refused with an error instead of being ignored: the sharded step waits
for the multi-GPU item (ROADMAP A12).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, train


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dp", type=int, default=0)
    ap.add_argument("--tp", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.dp or args.tp:
        ap.error("--dp / --tp: the sharded train step is not ported to "
                 "PyTorch yet (ROADMAP A12); train on one device")

    cfg = reduced_config(args.arch) if args.reduced else get_config(
        args.arch)
    tc = TrainConfig(steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, microbatches=args.microbatches,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     resume=args.resume, seed=args.seed,
                     step_deadline_s=args.deadline)
    oc = AdamWConfig(lr=args.lr)

    def extra(batch, seq, c):
        out = {}
        if c.n_vis_tokens:
            out["vis_embeds"] = torch.zeros(
                (batch, c.n_vis_tokens, c.d_model), dtype=torch.float32)
        if c.is_encdec:
            out["frames"] = torch.zeros(
                (batch, c.enc_seq, c.d_model), dtype=torch.float32)
        return out

    result = train(cfg, tc, oc, device=args.device,
                   extra_batch_fn=extra if (cfg.n_vis_tokens
                                            or cfg.is_encdec) else None)
    final = result["history"][-1]["loss"] if result["history"] else None
    print(f"[train] done. final loss={final}")


if __name__ == "__main__":
    main()
