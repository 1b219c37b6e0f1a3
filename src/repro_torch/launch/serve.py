"""Serving CLI of the port: random-init weights, QMC PTQ on the
device, batched requests through the paged engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \
      --weights qmc --paged-attention

Takes the JAX CLI's flags (``python -m repro.launch.serve``) plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch version of
every kernel). ``--pipelined`` runs the pipelined round loop; on the card
every step width is a captured CUDA graph. ``--temperature``,
``--top-k``, ``--top-p`` (with ``--seed`` and ``--logprobs``) set the
sampling policy of every request, ``--prefix-cache`` shares prompt-prefix
KV pages copy-on-write and ``--speculative K`` turns on self-speculative
decode, all with the JAX CLI's meanings:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --temperature 0.8 --prefix-cache --speculative 4

Observability, with the JAX CLI's meanings: ``--trace-out t.json``
writes a Perfetto-loadable Chrome trace of the run (round phase spans,
request lifecycle, scheduler, cache and graph-capture instants; see
``repro_torch.obs.trace``), ``--metrics-out m.json`` a snapshot of the
``serve_*`` metrics registry (``repro_torch.obs.metrics``),
``--cost-report`` turns on cost capture (``repro_torch.obs.costs``; every
step call becomes synchronous) and prints the per-width roofline table,
and ``--profile DIR`` wraps the run in ``torch.profiler`` (CPU and, on
the card, CUDA activity) and writes its Chrome trace under ``DIR``:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --trace-out t.json --metrics-out m.json --cost-report --profile p/

Hybrid, SSM and MoE stacks serve through the same flags (``--arch
hymba-1.5b``, ``--arch mamba2-370m``, ``--arch dbrx-132b``, ``--arch
jamba-1.5-large-398b``; ``--reduced`` is the default, ``--no-reduced`` the
full width); the features the engine refuses on a stack (``--prefix-cache``
and ``--speculative`` on hybrid and SSM ones) exit with the engine's
message, and so do the encoder-decoder and VLM architectures, which the
paged engine does not serve (as the JAX CLI has no flag for them):

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch dbrx-132b

``--data-shards D --model-shards M`` serve on a ``(data, model)`` mesh of
``D * M`` ranks over ``torch.distributed``: this process spawns them
(``launch.mesh.spawn``, file rendezvous in a temporary directory), every
rank runs the CLI on the same requests with its slice of the weights and
of the arena, and rank 0 prints. ``--dist-backend`` names the backend
(``gloo`` on the CPU, and for several ranks on one card; ``nccl`` for a
card per rank); there is no default. The ranks serve the QMC streams of
the run without shard flags, each cut at subtile boundaries into the
rank's TP slice (``launch.sharding.shard_params``), so the tokens are
that run's (the JAX CLI quantizes each shard on its own instead,
``tp_shards=model_shards``; ``quantize_for_serving(tp_shards=M,
only_shard=m)`` does that here). A mesh runs its steps eagerly (no CUDA
graphs). It serves dense, local/global, MoE (experts over ``model``: at
``--arch dbrx-132b --model-shards 2`` a rank holds half the experts),
SSM and hybrid stacks; the encoder-decoder and VLM architectures exit 2,
as they do without shard flags:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --data-shards 2 --model-shards 2 --dist-backend gloo
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch dbrx-132b --data-shards 2 --model-shards 2 --dist-backend gloo
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.launch import mesh as meshlib
from repro_torch.models.model import init_params
from repro_torch.obs import costs as obs_costs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import steps as serve_steps
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged_kv import pages_for
from repro_torch.serve.sampling import SamplingParams


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
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the k highest-logit tokens "
                         "(0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling: smallest token set with "
                         "cumulative mass >= p (1.0 = off)")
    ap.add_argument("--logprobs", action="store_true",
                    help="record each selected token's model logprob in "
                         "Request.out_logprobs")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="self-speculative decode: up to K prompt-lookup "
                         "draft tokens verified per greedy decode lane "
                         "per round (0 = off)")
    ap.add_argument("--pipelined", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV pages copy-on-write")
    ap.add_argument("--paged-attention",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="attend through the ragged paged-attention kernel "
                         "(default; --no-paged-attention takes the "
                         "full-width gather)")
    ap.add_argument("--chunked-prefill", action="store_true")
    ap.add_argument("--chunk-tokens", type=int, default=32)
    ap.add_argument("--sys-prompt-len", type=int, default=0)
    ap.add_argument("--data-shards", type=int, default=1,
                    help="mesh 'data' axis: shards the paged arena's page "
                         "pool")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="mesh 'model' axis: TP over heads / FFN / vocab "
                         "and the QMC streams")
    ap.add_argument("--dist-backend", choices=meshlib.BACKENDS,
                    help="torch.distributed backend of the mesh (required "
                         "with shard flags): gloo on the CPU or for ranks "
                         "sharing a card, nccl for a card per rank")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(load in Perfetto / chrome://tracing): per-round "
                         "phase spans plus request-lifecycle and "
                         "scheduler/cache instants")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="write a JSON snapshot of the serve_* metrics "
                         "registry after the run")
    ap.add_argument("--profile", metavar="DIR",
                    help="wrap the run in torch.profiler and write its "
                         "Chrome trace under DIR")
    ap.add_argument("--cost-report", action="store_true",
                    help="count each step width's FLOPs/bytes and print "
                         "the per-width roofline attribution table + "
                         "modeled memory-system cost after the run "
                         "(obs/costs.py; makes step calls synchronous)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels on the card) or cpu (plain "
                         "PyTorch versions)")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    shape = (args.data_shards, args.model_shards)
    if min(shape) < 1:
        ap.error("--data-shards and --model-shards must be >= 1")
    if shape != (1, 1):
        if args.dist_backend is None:
            ap.error("a mesh needs --dist-backend (gloo or nccl)")
        try:
            return meshlib.spawn(_cli_rank, shape,
                                 backend=args.dist_backend,
                                 args=(list(argv) if argv is not None
                                       else None,), timeout_s=3600.0)
        except RuntimeError as exc:
            if "NotImplementedError" in str(exc):
                ap.error(str(exc).strip().splitlines()[-1])
            raise
    return _main(ap, args)


def _cli_rank(mesh, argv):
    """One rank of a mesh run of the CLI: its own parse of the same
    arguments, the serve, and the requests' tokens back to the parent."""
    import sys
    ap = _parser()
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    eng = _main(ap, args, mesh)
    return [r.out_tokens for r in eng.last_requests]


def _main(ap, args, mesh=None):
    if args.cost_report:
        obs_costs.enable_capture()
    try:
        return _serve(args, mesh)
    except NotImplementedError as exc:
        # a feature the engine refuses for this stack (the prefix cache or
        # speculative decode on a hybrid / mamba stack, a mesh on one): its
        # message, no traceback
        if mesh is not None:
            raise
        ap.error(str(exc))
    finally:
        if args.cost_report:
            obs_costs.enable_capture(False)


def mesh_worker(mesh, job: dict) -> list:
    """One rank of a scripted mesh run (``launch.mesh.spawn(mesh_worker,
    shape, backend=..., args=(job,))``): ``job["models"]`` maps a name to
    its ``cfg`` and weights (``params``, a whole port tree that each rank
    slices, or ``params_np``, nested numpy dicts through
    ``bridge.params_from_numpy``); ``job["runs"]`` lists runs, each a
    ``model`` name, ``ServeEngine`` keywords (``engine``) and
    ``requests`` (or ``batches``, a list of request lists), served in
    order by one engine, so a prefix cache persists between them;
    ``job["device"]`` is the device.
    Returns, per run and batch, this rank's tokens, logprobs and stats,
    its kernel launches and qmm paths, and its collectives (in all and
    by kind: ``Mesh.by_kind`` calls)."""
    import copy
    import dataclasses as dc

    from repro_torch.bridge import params_from_numpy
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ops as kops
    weights = {}
    out = []
    for run in job["runs"]:
        model = job["models"][run["model"]]
        if run["model"] not in weights:
            weights[run["model"]] = model.get("params") or params_from_numpy(
                model["params_np"], device=job["device"])
        eng = ServeEngine(model["cfg"], weights[run["model"]], mesh=mesh,
                          cuda_graphs=False, device=job["device"],
                          **run.get("engine", {}))
        for batch in run.get("batches") or [run["requests"]]:
            reqs = copy.deepcopy(batch)
            kbuild.reset_launches()
            kops.reset_path_counts()
            c0, s0 = mesh.collectives, mesh.collective_seconds
            k0 = {k: v[0] for k, v in mesh.by_kind.items()}
            eng.run(reqs)
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            st = eng.stats
            out.append(dict(
                tokens=[r.out_tokens for r in reqs],
                logprobs=[r.out_logprobs for r in reqs],
                stats={f.name: getattr(st, f.name) for f in dc.fields(st)
                       if isinstance(getattr(st, f.name), (int, float))},
                launches=dict(kbuild.launches),
                paths=dict(kops.path_counts),
                collectives=mesh.collectives - c0,
                by_kind={k: v[0] - k0.get(k, 0)
                         for k, v in mesh.by_kind.items()},
                collective_s=mesh.collective_seconds - s0))
    return out


def _profiled_run(eng, reqs, out_dir: str) -> str:
    """``eng.run(reqs)`` under ``torch.profiler`` (CPU activity, and CUDA
    activity on the card); returns the Chrome trace written under
    ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        eng.run(reqs)
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "serve_trace.json")
    prof.export_chrome_trace(path)
    return path


def _serve(args, mesh=None):
    report = mesh is None or mesh.rank == 0
    out = print if report else (lambda *a, **k: None)
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
        out(f"[serve] QMC PTQ in {time.monotonic() - t0:.1f}s")
    if mesh is not None:
        out(f"[serve] mesh data={args.data_shards} "
            f"model={args.model_shards} over "
            f"{args.data_shards * args.model_shards} ranks "
            f"({args.dist_backend})")

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
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed,
                        logprobs=args.logprobs)
    tracer = None
    if args.trace_out:
        # the process default, so the deep call sites (scheduler, prefix
        # cache, step set) record into the same trace
        tracer = obs_trace.Tracer(enabled=True)
        prev_tracer = obs_trace.set_tracer(tracer)
    try:
        eng = ServeEngine(cfg, params, slots=args.slots, max_len=max_len,
                          page_size=args.page_size, chunk_tokens=chunk,
                          prefix_cache=args.prefix_cache,
                          paged_attention=args.paged_attention,
                          sampling=sp, speculative_k=args.speculative,
                          pipelined=args.pipelined, device=args.device,
                          cuda_graphs=mesh is None, mesh=mesh,
                          tracer=tracer)
        if args.profile:
            path = _profiled_run(eng, reqs, args.profile)
            print(f"[serve] torch.profiler trace -> {path}")
        else:
            eng.run(reqs)
        eng.last_requests = reqs
    finally:
        if tracer is not None:
            obs_trace.set_tracer(prev_tracer)
    if not report:
        return eng
    s = eng.stats
    if tracer is not None:
        n_ev = tracer.export(args.trace_out)
        print(f"[serve] trace: {n_ev} events -> {args.trace_out}")
    if args.metrics_out:
        obs_metrics.get_registry().write_json(args.metrics_out)
        print(f"[serve] metrics snapshot -> {args.metrics_out}")
    print(f"[serve] {s.prefills} prefills ({s.prefill_chunks} chunks of "
          f"<= {chunk} tokens), {s.decode_steps} decode steps, "
          f"{s.tokens_out} tokens in {s.wall_s:.2f}s "
          f"({s.tokens_per_s:.1f} tok/s) on {eng.device}")
    if mesh is not None:
        print(f"[serve] rank 0: {mesh.collectives} collectives in "
              f"{mesh.collective_seconds:.3f}s over {s.rounds} rounds")
    if s.phase_seconds:
        print(f"[serve] phases: host={s.host_seconds():.3f}s "
              f"device={s.device_seconds():.3f}s over {s.rounds} rounds "
              f"({s.graph_captures} graph captures, "
              f"{s.capture_s:.2f}s)")
    if args.pipelined:
        print(f"[serve] pipelined: {s.pipelined_rounds}/{s.rounds} "
              f"rounds overlapped ({s.pipeline_overlap:.0%}), "
              f"{s.pipeline_barriers} drains, "
              f"{s.lag_trimmed_tokens} lag-trimmed tokens")
    if s.ttft_s:
        print(f"[serve] TTFT p50={np.percentile(s.ttft_s, 50) * 1e3:.1f}ms "
              f"p95={np.percentile(s.ttft_s, 95) * 1e3:.1f}ms")
    if args.paged_attention and s.kv_pages_full \
            and cfg.has_kind(("attn", "hybrid")):
        print(f"[serve] paged-attention kernel: {s.kv_pages_live} live "
              f"pages streamed vs {s.kv_pages_full} full-width")
    if args.prefix_cache:
        print(f"[serve] prefix cache: {s.cache_hits} hits, "
              f"hit_rate={s.hit_rate:.2f}, prefill-token reduction="
              f"{s.prefill_token_reduction:.2f}, {s.cow_copies} COW copies")
    if s.dedup_hits:
        print(f"[serve] in-flight dedup: {s.dedup_hits} admissions "
              f"aliased a live identical prompt")
    if args.temperature > 0:
        print(f"[serve] sampling: temperature={args.temperature} "
              f"top_k={args.top_k} top_p={args.top_p} seed={args.seed}")
    if args.speculative > 0:
        print(f"[serve] speculative k={args.speculative}: "
              f"{s.spec_rounds} verify rounds, "
              f"{s.spec_accepted_tokens}/{s.spec_draft_tokens} drafts "
              f"accepted (rate={s.spec_acceptance_rate:.2f})")
    if args.logprobs and reqs and reqs[0].out_logprobs:
        lp = reqs[0].out_logprobs[:5]
        print(f"[serve] req 0 logprobs: "
              f"{[round(x, 3) for x in lp]}...")
    if args.cost_report and eng.last_cost_report is not None:
        print("[serve] cost attribution (measured vs H100 roofline, "
              "obs/costs.py):")
        print(eng.last_cost_report.table())
    for r in reqs[:3]:
        print(f"  req {r.uid}: {r.out_tokens[:10]}...")
    return eng


if __name__ == "__main__":
    main()
