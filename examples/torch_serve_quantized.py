"""Batched serving with QMC deployment-format weights on the PyTorch port
(counterpart of ``examples/serve_quantized.py``): the paper's
edge-inference scenario. Requests stream through the paged
continuous-batching engine (every active slot decodes in one step against
the shared paged KV pool) while the weights stay in the dual-stream
format and go through the qmm kernels on the card; the legacy per-slot
engine runs as the baseline.

  PYTHONPATH=src python examples/torch_serve_quantized.py       # the card
  PYTHONPATH=src python examples/torch_serve_quantized.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs import reduced_config
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.models.model import init_params
from repro_torch.serve.engine import LegacyServeEngine, Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config("qwen2.5-1.5b")
    params = init_params(cfg, 0, device=args.device)

    print("quantizing weights to the QMC serving format (rho=0.3, 3b/5b)...")
    t0 = time.monotonic()
    qparams = quantize_for_serving(params,
                                   QMCConfig(rho=0.3, granularity="subtile"),
                                   tp_shards=1, min_dim=64)
    print(f"  done in {time.monotonic() - t0:.1f}s")

    rng = np.random.default_rng(0)
    requests = [Request(uid=i,
                        prompt=rng.integers(2, cfg.vocab, size=12).astype(
                            np.int32),
                        max_new_tokens=12)
                for i in range(6)]

    first = {}
    for name, p, engine_cls in (
            ("fp32 legacy", params, LegacyServeEngine),
            ("fp32 paged", params, ServeEngine),
            ("QMC paged", qparams, ServeEngine)):
        reqs = [Request(uid=r.uid, prompt=r.prompt,
                        max_new_tokens=r.max_new_tokens) for r in requests]
        eng = engine_cls(cfg, p, slots=3, max_len=32, device=args.device)
        eng.run(reqs)
        s = eng.stats
        print(f"{name:12s}: {s.tokens_out} tokens, {s.prefills} prefills, "
              f"{s.decode_steps} decode calls, {s.tokens_per_s:.1f} tok/s")
        print(f"   first output: {reqs[0].out_tokens}")
        first[name] = [r.out_tokens for r in reqs]
    assert first["fp32 legacy"] == first["fp32 paged"], \
        "the paged engine should give the legacy engine's greedy tokens"
    print("OK: fp32 paged = fp32 legacy, token for token.")


if __name__ == "__main__":
    main()
