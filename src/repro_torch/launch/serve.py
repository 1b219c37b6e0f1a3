"""Serving CLI of the port: random-init weights, QMC PTQ on the
device, batched requests through the paged engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \
      --weights qmc --paged-attention

Takes the JAX CLI's flags (``python -m repro.launch.serve``) plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch version of
every kernel). Flags of features not ported yet (sampling, speculative
decode, the pipelined loop, the prefix cache, meshes, tracing and
profiling) are refused with an error instead of being ignored.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.models.model import init_params
from repro_torch.serve import steps as serve_steps
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged_kv import pages_for


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--weights", choices=["fp16", "qmc"], default="qmc")
    ap.add_argument("--rho", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--logprobs", action="store_true")
    ap.add_argument("--speculative", type=int, default=0, metavar="K")
    ap.add_argument("--pipelined", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--paged-attention",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="attend through the ragged paged-attention kernel "
                         "(default; --no-paged-attention takes the "
                         "full-width gather)")
    ap.add_argument("--chunked-prefill", action="store_true")
    ap.add_argument("--chunk-tokens", type=int, default=32)
    ap.add_argument("--sys-prompt-len", type=int, default=0)
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--trace-out", metavar="PATH")
    ap.add_argument("--metrics-out", metavar="PATH")
    ap.add_argument("--profile", metavar="DIR")
    ap.add_argument("--cost-report", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels on the card) or cpu (plain "
                         "PyTorch versions)")
    return ap


def _refuse_unported(ap, args) -> None:
    unported = {
        "--temperature": args.temperature > 0,
        "--top-k": args.top_k != 0,
        "--top-p": args.top_p != 1.0,
        "--speculative": args.speculative != 0,
        "--pipelined": args.pipelined,
        "--prefix-cache": args.prefix_cache,
        "--data-shards": args.data_shards != 1,
        "--model-shards": args.model_shards != 1,
        "--trace-out": args.trace_out is not None,
        "--metrics-out": args.metrics_out is not None,
        "--profile": args.profile is not None,
        "--cost-report": args.cost_report,
    }
    bad = [flag for flag, on in unported.items() if on]
    if bad:
        ap.error(f"not ported to the PyTorch engine yet: {', '.join(bad)}")


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    _refuse_unported(ap, args)
    cfg = reduced_config(args.arch) if args.reduced else get_config(
        args.arch)
    params = init_params(cfg, args.seed, device=args.device)
    if args.weights == "qmc":
        t0 = time.monotonic()
        params = quantize_for_serving(
            params, QMCConfig(rho=args.rho, granularity="subtile"),
            min_dim=64)
        if args.device != "cpu":
            torch.cuda.synchronize()
        print(f"[serve] QMC PTQ in {time.monotonic() - t0:.1f}s")

    rng = np.random.default_rng(args.seed)
    sys_prompt = rng.integers(2, cfg.vocab, size=args.sys_prompt_len)
    reqs = [Request(uid=i,
                    prompt=np.concatenate(
                        [sys_prompt,
                         rng.integers(2, cfg.vocab, size=args.prompt_len)]
                    ).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    max_len = args.sys_prompt_len + args.prompt_len + args.new_tokens + 4
    mpps = pages_for(max_len, args.page_size)
    chunk = (args.chunk_tokens if args.chunked_prefill
             else serve_steps.default_chunk(mpps, args.page_size))
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=max_len,
                      page_size=args.page_size, chunk_tokens=chunk,
                      paged_attention=args.paged_attention,
                      device=args.device)
    eng.run(reqs)
    s = eng.stats
    print(f"[serve] {s.prefills} prefills ({s.prefill_chunks} chunks of "
          f"<= {chunk} tokens), {s.decode_steps} decode steps, "
          f"{s.tokens_out} tokens in {s.wall_s:.2f}s "
          f"({s.tokens_per_s:.1f} tok/s) on {eng.device}")
    if s.ttft_s:
        print(f"[serve] TTFT p50={np.percentile(s.ttft_s, 50) * 1e3:.1f}ms "
              f"p95={np.percentile(s.ttft_s, 95) * 1e3:.1f}ms")
    if args.paged_attention and s.kv_pages_full:
        print(f"[serve] paged-attention kernel: {s.kv_pages_live} live "
              f"pages streamed vs {s.kv_pages_full} full-width")
    for r in reqs[:3]:
        print(f"  req {r.uid}: {r.out_tokens[:10]}...")
    return eng


if __name__ == "__main__":
    main()
