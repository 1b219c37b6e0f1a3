"""Quickstart on the PyTorch port: quantize a model with QMC and see the
accuracy/compression trade-off in seconds (counterpart of
``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py            # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import reduced_config
from repro_torch.core.apply import model_bits_per_weight, quantize_model
from repro_torch.core.qconfig import QMCConfig
from repro_torch.models.model import forward, init_params


def drift(a, b) -> float:
    return float(torch.mean(torch.abs(a - b))
                 / (torch.mean(torch.abs(a)) + 1e-9))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    # 1. Build a small model (any of the 14 registered archs shrinks the
    #    same way; try "gemma2-2b", "mamba2-370m", "jamba-1.5-large-398b").
    cfg = reduced_config("stablelm-1.6b")
    params = init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=dev)
    logits_fp = forward(cfg, params, tokens)

    # 2. Run Algorithm 1 (outlier-aware robust quantization) over the
    #    weights.
    qmc = QMCConfig(rho=0.3, bits_in=3, bits_out=5, cell_bits=3)
    qparams = quantize_model(params, method="qmc", qmc=qmc, min_dim=64)
    logits_q = forward(cfg, qparams, tokens)

    # 3. Compare against plain INT4 rounding and simulated ReRAM read
    #    noise.
    rparams = quantize_model(params, method="rtn4", min_dim=64)
    logits_r = forward(cfg, rparams, tokens)
    noise = torch.Generator(device=dev).manual_seed(7)
    nparams = quantize_model(params, method="qmc", qmc=qmc, noise_gen=noise,
                             min_dim=64)
    logits_n = forward(cfg, nparams, tokens)

    n_params = sum(t.numel() for t in _tensors(params))
    print(f"model: {cfg.name} ({n_params:,} params) on {dev}")
    print(f"avg bits/weight QMC : "
          f"{model_bits_per_weight(params, 'qmc', qmc):.2f} "
          f"(={16 / qmc.avg_bits:.2f}x compression on quantized layers)")
    print(f"logit drift  QMC            : {drift(logits_fp, logits_q):.4f}")
    print(f"logit drift  RTN-INT4       : {drift(logits_fp, logits_r):.4f}")
    print(f"logit drift  QMC+ReRAMnoise : {drift(logits_fp, logits_n):.4f}")
    assert drift(logits_fp, logits_q) < drift(logits_fp, logits_r), \
        "QMC should beat plain INT4 rounding"
    print("OK: QMC < RTN drift, as the paper claims.")


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


if __name__ == "__main__":
    main()
