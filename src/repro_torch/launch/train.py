"""Training CLI of the port (counterpart of ``repro.launch.train``):
random-init weights from ``--seed``, the synthetic corpus, AdamW, atomic
async checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt --resume

Runs on the card (``--device cuda``, the default) or, asked, on the CPU
(``--device cpu``). On restart after a crash or kill, ``--resume`` picks
up from the newest checkpoint, whatever mesh wrote it.

``--dp D --tp M`` train on a ``(D, M)`` mesh (FSDP on data, TP and expert
parallelism on model; ``train.step.build_train_step``; every stack of the
registry, encoder-decoder and VLM stacks with their ``frames`` /
``vis_embeds`` rows beside the tokens', and heads or a vocab that do not
divide ``M`` replicated): this process spawns ``D * M`` ranks
over ``torch.distributed`` (``launch.mesh.spawn``, file rendezvous in a
temporary directory) and rank 0 logs and prints the final loss.
``--dist-backend`` names the backend and has no default: ``gloo`` on the
CPU and for several ranks sharing one card, ``nccl`` for a card per
rank. On the CPU (~10 s)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --dp 2 --tp 2 --device cpu --dist-backend gloo
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --reduced --steps 20 --dp 2 --tp 2 --device cpu --dist-backend gloo
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium \
      --reduced --steps 5 --dp 2 --tp 2 --device cpu --dist-backend gloo
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import mesh as meshlib
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
    ap.add_argument("--dist-backend", choices=meshlib.BACKENDS,
                    default=None,
                    help="the collectives' backend of a mesh (required "
                         "with --dp / --tp)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.dp or args.tp:
        if args.dist_backend is None:
            ap.error("a mesh needs --dist-backend (gloo or nccl)")
        shape = (args.dp or 1, args.tp or 1)
        try:
            losses = meshlib.spawn(_rank, shape, backend=args.dist_backend,
                                   args=(args,), timeout_s=3600.0)
        except RuntimeError as exc:
            if "NotImplementedError" in str(exc):   # a stack the mesh
                ap.error(str(exc).strip().splitlines()[-1])  # refuses
            raise
        print(f"[train] done on a {shape} mesh. final loss={losses[0]}")
        return losses[0]
    result = _train(args)
    final = result["history"][-1]["loss"] if result["history"] else None
    print(f"[train] done. final loss={final}")
    return final


def _rank(mesh, args):
    """One rank of a mesh run: the loop on its slices; its final loss."""
    result = _train(args, mesh)
    return result["history"][-1]["loss"] if result["history"] else None


def _train(args, mesh=None):
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

    return train(cfg, tc, oc, mesh, device=args.device,
                 extra_batch_fn=extra if (cfg.n_vis_tokens
                                          or cfg.is_encdec) else None)


if __name__ == "__main__":
    main()
