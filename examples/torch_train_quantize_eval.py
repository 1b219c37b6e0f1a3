"""End-to-end example on the PyTorch port (counterpart of
``examples/train_quantize_eval.py``): train a ~100M-param SLM for a few
hundred steps on the synthetic corpus, PTQ it with every method, and
report held-out PPL: the paper's Table-2 pipeline at laptop scale.

  PYTHONPATH=src python examples/torch_train_quantize_eval.py [--steps 300]
  (use --small for a fast demo model, --device cpu for the CPU)
"""
import argparse
import math

import torch

from repro_torch.core.apply import quantize_model
from repro_torch.core.qconfig import QMCConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="build/example_ckpt")
    args = ap.parse_args(argv)
    dev = args.device

    if args.small:
        cfg = ModelConfig(name="demo-20m", family="dense", n_layers=4,
                          d_model=256, n_heads=8, n_kv_heads=4, d_ff=512,
                          vocab=512)
    else:
        # ~100M params: 12 x (d=768, ff=2048) + 32k vocab
        cfg = ModelConfig(name="demo-100m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                          vocab=32768)

    print(f"[1/3] training {cfg.name} "
          f"({cfg.param_count() / 1e6:.0f}M params) for {args.steps} "
          f"steps on {dev}...")
    tc = TrainConfig(steps=args.steps, global_batch=16, seq_len=128,
                     log_every=25, warmup=20, ckpt_dir=args.ckpt_dir,
                     ckpt_every=100, resume=True)
    out = train(cfg, tc, AdamWConfig(lr=1.5e-3), device=dev)
    params, corpus = out["params"], out["corpus"]
    losses = [h["loss"] for h in out["history"]]
    if len(losses) > 1:
        assert losses[-1] < losses[0], f"the loss did not fall: {losses}"

    def ppl(p) -> float:
        tot, cnt = 0.0, 0
        for b in corpus.heldout_ppl_batches(3, 8, 128):
            toks = torch.as_tensor(b["tokens"], device=dev).long()
            labels = torch.as_tensor(b["labels"], device=dev).long()
            logits = forward(cfg, p, toks).to(torch.float32)
            lse = torch.logsumexp(logits, -1)
            gold = torch.gather(logits, -1, labels[..., None])[..., 0]
            tot += float(torch.sum(lse - gold))
            cnt += labels.numel()
        return math.exp(tot / cnt)

    print("[2/3] post-training quantization (all methods)...")
    rows = [("fp16", params, 1.0)]
    rows.append(("rtn-int4", quantize_model(params, "rtn4"), 4.0))
    rows.append(("mxint4", quantize_model(params, "mx4"), 16 / 4.25))
    qmc = QMCConfig(rho=0.3, cell_bits=3)
    rows.append(("qmc (no noise)", quantize_model(params, "qmc", qmc=qmc),
                 16 / 3.6))
    noise = torch.Generator(device=dev).manual_seed(5)
    rows.append(("qmc (3b-MLC noise)",
                 quantize_model(params, "qmc", qmc=qmc, noise_gen=noise),
                 16 / 3.6))

    print("[3/3] held-out perplexity:")
    print(f"{'method':22s} {'ppl':>8s} {'compression':>12s}")
    for name, p, comp in rows:
        value = ppl(p)
        assert math.isfinite(value), f"{name}: perplexity {value}"
        print(f"{name:22s} {value:8.3f} {comp:11.2f}x")


if __name__ == "__main__":
    main()
