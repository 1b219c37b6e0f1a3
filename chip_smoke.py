#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):

  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — nvcc builds the kernels from ``src/repro_torch/csrc``;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the main path's shapes (attention also over bf16 q and
                bf16 pages, and at hymba-1.5b's: G = 5, window 1024,
                decode at kv_len 2048 and a 128-token chunk past position
                1024), with its time, the plain
                version's, a library call's (yardstick only; the
                kernel/library ratio is what compares across cards) and
                its bound; the decode-width qmm also at M=64 (eight M
                tiles) and both qmm kernels on all-inlier, all-outlier
                and checkerboard weights, attention also on decode lanes
                at kv_len up to 4096 (split over spans); and the time of
                an empty kernel launch, the floor under any one-launch
                call; the attention kernel over a data rank's page slice
                (D = 2) at the serve phase's decode and chunk shapes and
                at hymba-1.5b's decode (G = 5, window 1024), against the
                sliced plain version, with the merge of the two slices
                against the whole-arena call;
  4. serve    — full-width stablelm-1.6b (random weights from a seed, QMC
                PTQ on the card), 8 requests through the paged engine with
                the qmm streams and paged attention, three times: (a)
                eager, (b) one CUDA graph per step width, (c) graphs and
                the pipelined loop; each engine runs the requests once
                (the graphs are captured there) and then again, measured,
                with the launch counts set to 0 just before it. The tokens
                must be identical in all three; in every run each kernel
                of the path must have launched (on replay, too) and the
                qmm "ref" path must not; captures stay within the declared
                widths. One eager step runs under the CUDA sync debugger,
                and torch.profiler reads the device's idle share over a
                steady decode window of (a) and (b);
  4s. mesh    — sharded serving of the same model and requests on gloo
                ranks sharing the card (launch.mesh.spawn): (2, 1) on the
                serve phase's streams gives exactly its greedy tokens;
                (1, 2) and (2, 2) on tp_shards = 2 streams, each rank
                quantizing its own shard (bit-equal to the whole
                conversion's), give the tokens of one process serving the
                whole conversion (4 of the prompts, 12 new tokens each);
                every rank launches B1, B2 and B3 and
                never qmm's "ref" path; the collectives a round and their
                seconds, and which collectives gloo takes on CUDA tensors;
  4x. serve-x — the same width and engine settings: sampled lanes (half
                the serve phase's requests at temperature 0.8, top_k 50,
                top_p 0.95, one at top_k 1) graphed twice, alone through
                the solo step and eagerly, identical draws, top_k 1 equal
                to the greedy run (a), one sampled step under the sync
                debugger, the graph pool's bytes beside (b)'s; the prefix
                cache (a 128-token shared prefix and an identical
                page-aligned pair) against the uncached engine, whose
                in-flight dedup shares the pair: identical tokens, hits,
                dedup and COW, fewer prefilled tokens, a second run on the
                persisted cache; speculative decode (k = 4, repeated
                phrases) graphed and graphed+pipelined equal to plain
                greedy; every run launches each serving kernel and never
                qmm's "ref" path; the sampling head's time at C = 1 and
                256 and its threefry bits against the CPU's;
  4o. obs     — observability on the serve phase's settings: (i) the
                graphed engine with an enabled tracer and a registry, (ii)
                the same pipelined: tokens identical to the untraced run,
                phase spans well formed, one req/first_token per request,
                serve_rounds_total equal to the rounds, the phase
                breakdown at p50 with host and device seconds against
                wall, and the host ms of one step call and of its graph's
                replay call beside the replay's device ms; (iii) a cost-captured run: one attributed step
                dispatch per round, the per-width table (calls, ms per
                call, FLOPs, bytes, H100 roofline ms, drift) and one step
                under the sync debugger with the tracer and capture on;
                (iv) three alternated pairs of tracing-off/on runs, tok/s
                and the median ratio; (v) the serving CLI at full width
                with --trace-out, --metrics-out, --cost-report and
                --profile into build/obs, with the files' sizes;
  4h. hybrid  — hybrid and SSM stacks at full width, random weights from
                the seed, QMC PTQ with rho 0.3 on the card, the serve
                phase's 8 requests and engine settings: hymba-1.5b (32
                layers, d 1600, 25/5 heads, window 1024, d_state 128)
                eager, graphed and graphed+pipelined, and mamba2-370m (48
                layers, d 1024, attention-free) eager and graphed, each
                run once to capture and once measured; tokens identical
                across the runs of an arch; attention launched in every
                hymba run and the decode and column-strip qmm in every
                mamba2 run, on replay too; qmm's "ref" path exactly the
                calls qmm_plan sends there (hymba's 1600 x 5504 w_up /
                w_gate: K = 1600 does not tile); one eager step under the
                sync debugger; torch.profiler's busy time by kernel over a
                decode window of (b); the decode round by part (the "ref"
                qmm, the dense projections, the Mamba2 mixers), each part
                one timed CUDA graph; one whole step through the kernels
                against the plain versions (logits within 1e-3 x
                max|logits|);
  4m. moe     — dbrx-132b at its published widths (d 6144, 48/8 heads,
                d_ff 10752, 16 experts top-4, vocab 100352), depth cut to 2
                of 40 layers, random weights from the seed, QMC PTQ with
                rho 0.3 on the card (the fp32 tree freed after it), the
                serve phase's 8 requests and engine settings eager, graphed
                and graphed+pipelined, each once to capture and once
                measured: tokens identical, qmm_decode and attention
                launched in every run (on replay too), qmm's "ref" path
                never; one eager step under the sync debugger; the decode
                window's busy time by torch.profiler, the round's MoE FFNs
                (router, dispatch, the expert products, combine) as one
                timed CUDA graph and the expert products alone as another,
                beside the step's counted byte floor; one whole step
                through the kernels against the plain versions (logits
                within 1e-3 x max|logits|); the decode qmm at the expert
                shapes is timed in phase 3;
  4e. mesh-x  — MoE, SSM and hybrid stacks on gloo ranks sharing the card,
                on the [moe] and [hybrid] phases' streams (no second init
                or PTQ), 4 of the serve prompts with 12 new tokens each,
                eager, all at (2, 2) in one spawn: dbrx-132b (2 layers;
                expert parallelism, 8 of the 16 experts a rank), then
                mamba2-370m (in_proj gathered, the mixer replicated),
                then hymba-1.5b (its 25 heads and 5 KV heads do not
                divide 2: every model rank runs the whole attention
                block, the attention kernel over its page slice of all
                5 KV heads; the mixer and the FFN cut); every rank gives
                one process's tokens on the same streams, launches the
                decode qmm (dbrx, mamba2), the attention kernel (dbrx,
                hymba) and every kernel one process launches, takes
                qmm's "ref" path only as the plan sends its own leaves
                there (hymba's K = 1600 leaves), holds every KV head
                where the heads replicate
                (its arena's KV columns), and a dbrx rank holds half the
                expert codes (its bytes against the whole); rank 0's
                collectives a round by kind, the phase's seconds; then,
                in the same spawn, [mesh-contig]: whisper-medium and
                internvl2-2b at full width on the [families] phase's
                streams (CUDA IPC, no second PTQ, cut to each rank's
                slices), serve.steps.build_prefill over a rank's row of
                the batch of 2 and 16 greedy build_decode steps: every
                rank's logits (gathered over the mesh) within 1e-3 x
                max|logits| of one process's family_run through the
                kernels, its greedy tokens equal, the decode qmm
                launched, its cache holding 1/M of the KV columns; the
                collectives by kind;
  4f. families — (before 4e, whose [mesh-contig] runs on its streams)
                the contiguous-cache surface at full width: whisper-medium
                (24 encoder + 24 decoder layers, 1500 frames) and
                internvl2-2b (24 layers, 256 vision embeddings), random
                weights, QMC PTQ rho 0.3, a batch of 2 with seeded frames or
                vision embeddings: prefill and 16 greedy decode steps
                through the kernels and through the plain versions, and
                the decode logits against one full forward (both within
                1e-3 x max|logits|); the encoder's time and the qmm route
                its 3000-row projections take. Then LegacyServeEngine on
                the serve phase's stablelm-1.6b weights and 8 requests
                against the paged engine's tokens: where they part, the
                legacy logits there must be a near tie (top-2 gap below
                1e-3 x max|logits|);
  4g. dryrun  — on the host alone: launch.dryrun.run_cell for
                stablelm-1.6b's train_4k, prefill_32k and decode_32k cells
                on the single-node production mesh (32 nodes of 8 H100s),
                rank 0 on meta tensors under a DryMesh: counted FLOPs and
                bytes, collectives by kind, argument bytes and roofline
                terms against the H100 SXM5 datasheet's peaks (labelled:
                not measurements);
  4a. attn-hd — the attention kernel's head dims 80 and 256 on the
                engine's default route: stablelm-3b (hd 80, 32 heads, d
                2560) and gemma2-2b (hd 256, 8/4 heads, window 4096,
                attention softcap 50, tied head, vocab 256000) at their
                published widths, depth cut to 2 layers (gemma2: one
                (local, global) group), random weights, QMC PTQ rho 0.3,
                the serve phase's 8 requests eager and graphed (tokens
                identical, every serving kernel launched), one whole step
                through the kernels against the plain versions (logits
                within 1e-3 x max|logits|); their attention shapes are
                timed in phase 3 over fp32, bf16 and int8 pages;
  5. step     — one mixed ragged step at full width through the kernels
                and through the plain versions, logits compared;
  6. ptq      — the PTQ entry point at full stablelm-1.6b width: unpack3b
                against its plain version at the read path's sizes, with
                its time; quantize_model with every ported method and the
                cache-less forward on one 2 x 256 token batch (finite
                logits, QMC drifts less than RTN-INT4, as
                examples/quickstart.py asserts); the ReRAM read path
                (every inlier stream of the serve phase's QTensors packed
                to 3 bits and decoded by the unpack3b kernel, bit-exact);
                the fig4 memory co-design rows for hymba-1.5b. GPTQ and
                AWQ calibrate on the taps of that forward (2 x 256 tokens,
                every layer); their drift against RTN-INT4's is printed,
                not required;
  7. train    — chunked_ce_loss and sharded_ce_loss against
                cross_entropy_loss (loss and gradients) at vocab 100352, d
                2048; then train() on stablelm-1.6b at full width and
                depth, fp32 with fp32 AdamW moments, batch 8 x 128 of the
                synthetic corpus, 8 steps after a 2-step warmup: ms a
                step, peak memory, the losses (all finite, the last two
                steps' mean below the first step's), the parameters moved;
  7m. train-mesh — sharded training (FSDP on data, TP on model) of
                stablelm-1.6b at full width (TRAIN_MESH_LAYERS = 4 of its
                24 layers) on gloo ranks sharing the card:
                step 0's gradients of the sharded step and train() at
                (2, 2) for TRAIN_MESH_STEPS steps with remat, batch 8 x
                128, then, after those ranks have exited, the same on a
                (1, 1) mesh in one process (its spawns shared with
                train-mesh-x's runs of the same shape): each leaf's whole
                gradient by its norm and a seeded projection, summed from
                the ranks' slices (tree_fingerprints), within
                TRAIN_MESH_GRAD_TOL, losses and grad norms within
                TRAIN_MESH_RTOL, every rank's metrics
                rank 0's; each rank's peak memory a step (at most its
                slice of the one process's, one gathered layer group and
                1 GiB) and their sum; the collectives a step by kind,
                their seconds and payload bytes;
  7x. train-mesh-x — MoE, SSM, hybrid, encoder-decoder and VLM stacks on
                the training mesh, gloo ranks sharing the card, as
                train-mesh checks stablelm, all at (2, 2) in train-mesh's
                spawn: mamba2-370m (full: 48 layers, d 1024; in_proj cut
                over model and gathered, the mixer replicated with whole
                gradients), hymba-1.5b (full width, 4 of its 32 layers;
                its 25 heads and 5 KV heads do not divide 2, so its
                attention block and its 32001-row embedding replicate
                over model with whole gradients), whisper-medium (full
                width, 2 of 24 encoder and 2 of 24 decoder layers over
                1500 frames; vocab 51865 replicated) and internvl2-2b
                (full width, 2 of 24 layers, 256 visual tokens; vocab
                92553 replicated), the frames and visual embeddings
                seeded (extra_batch), each step 0's gradients and 3
                steps of train() against one process on a (1, 1) mesh
                (the references in one spawn), with each run's seconds;
                then dbrx-132b at its published widths, 1 of its 40
                layers (4.49 G parameters, 18.0 GB fp32), batch 2 x 64,
                capacity factor 1.25: step 0 in one process, then at
                (1, 2) (expert parallelism, 8 whole experts a rank) on
                the same tree handed over by CUDA IPC: the routing of
                every call identical to one process's (expert ids, kept
                mask, the smallest top-k margin printed), assignments
                dropped, the loss and aux, the gradients leaf by leaf;
                each rank's peak against its slice of one process's, the
                collectives by kind, the counted matmul TFLOP of a step
                (obs.costs.train_step_work), the phase's seconds.

The line before the last is a JSON object with one row per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or copied somewhere without ``src/repro_torch`` beside it, the script
exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    # run alone, without the program: fail before printing any result
    sys.exit("chip_smoke: src/repro_torch is not beside this script; run "
             "it from the root of a checkout of the repository")
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import memsys  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.apply import (model_bits_per_weight,  # noqa: E402
                                    quantize_model)
from repro_torch.core.packing import pack_codes, packed_nbytes  # noqa: E402
from repro_torch.core.qconfig import QMCConfig  # noqa: E402
from repro_torch.core.qtensor import (QTensor,  # noqa: E402
                                      dequantize_qtensor, quantize_qtensor)
from repro_torch.core.qtensor_sharded import ShardedQTensor  # noqa: E402
from repro_torch.core.serving_quant import quantize_for_serving  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    merge_slices, q_block_for, ragged_paged_attention_call)
from repro_torch.kernels.qmm import (empty_launch,  # noqa: E402
                                     qmm_colstrip, qmm_decode)
from repro_torch.kernels.ref import (qmm_ref,  # noqa: E402
                                     ragged_paged_attention_ref,
                                     unpack3b_ref)
from repro_torch.kernels.unpack3b import unpack3b_call  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models.attention import paged_cache_read  # noqa: E402
from repro_torch.models.kvcache import quantize_kv  # noqa: E402
from repro_torch.models.chunked_ce import (chunked_ce_loss,  # noqa: E402
                                           sharded_ce_loss)
from repro_torch.models.layers import (attn_replicated,  # noqa: E402
                                       cross_entropy_loss)
from repro_torch.models.model import (decode_step, encode,  # noqa: E402
                                      forward, init_params, prefill,
                                      train_loss)
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.tree import items as tree_items  # noqa: E402
from repro_torch.tree import leaves as tree_leaves  # noqa: E402
from repro_torch.train.trainer import TrainConfig, train  # noqa: E402
from repro_torch.obs import costs as obs_costs  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serve import steps as serve_steps  # noqa: E402
from repro_torch.serve.engine import (LegacyServeEngine,  # noqa: E402
                                      Request, ServeEngine)
from repro_torch.serve.paged_kv import PagedKVPool  # noqa: E402
from repro_torch.serve import sampling as samplib  # noqa: E402
from repro_torch.serve.sampling import (DEAD_TOKEN,  # noqa: E402
                                        SamplingParams)

QMM_SHAPES = [(2048, 2048), (2048, 5632), (5632, 2048), (2048, 100352)]
SERVE_KERNELS = ("qmm_decode", "qmm_colstrip", "ragged_paged_attention")
# codes: the benchmarks/kernels.py size; the inlier stream of one
# 2048 x 5632 projection and of the 2048 x 100352 head at rho 0.3; a
# multiple of 8 that is not one of 32; and one that is not a multiple of 8
# (the kernel's partial last quad)
UNPACK_SIZES = [65_536, 8_074_240, 143_864_832, 65_544, 65_541]
PTQ_METHODS = [("fp16", "fp16", False), ("rtn4", "rtn4", False),
               ("mx4", "mx4", False), ("qmc", "qmc", False),
               ("qmc+ReRAM noise", "qmc", True), ("qtensor", "qtensor", False),
               ("gptq", "gptq", False), ("awq", "awq", False)]
TOL_QMM = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # x max|y|
ATT_ATOL, ATT_RTOL = 1e-5, 1e-4
HYMBA_DECODE = "hymba decode kv_len<=2048 G=5 win 1024"
HYMBA_CHUNK = "hymba chunk S=128 pos>1024 G=5 win 1024"
DBRX_DECODE = "dbrx decode hd 128 G=6"
DBRX_CHUNK = "dbrx chunk S=128 hd 128 G=6"
S3B_DECODE = "stablelm-3b decode hd 80"
S3B_CHUNK = "stablelm-3b chunk S=128 hd 80"
G2_DECODE = "gemma2 decode hd 256 G=2 win 4096 cap 50"
G2_CHUNK = "gemma2 chunk S=128 hd 256 G=2 win 4096 cap 50"
SLICED_DECODE = "stablelm decode D=2 page slices"
SLICED_CHUNK = "stablelm chunk S=128 D=2 page slices"
SLICED_HYMBA = "hymba decode D=2 page slices G=5 win 1024"
PAGE_KINDS = ("float32", "bfloat16", "int8")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def peaks(name: str):
    """(memory bytes/s, fp32 FLOP/s, TF32 FLOP/s, row name) of the card,
    from the port's table (``repro_torch/launch/roofline.py:PEAKS``, NVIDIA
    H100 datasheet)."""
    bw, fl, tc, frag, matched = rl.peaks(name)
    if not matched:
        print(f"[device] {name!r} is not in the peak table; bounds use the "
              f"H100 SXM figures")
    return bw, fl, tc, frag


class Timer:
    """Device time of one call: the median of per-run CUDA-event times
    after warm-up, with the L2 cache flushed before each run (the serving
    path streams every weight once per step, so it finds them cold). A
    spin on the card before each run lets the host enqueue the whole call
    first, so the events bracket device work only; ``host`` gives the
    host's own cost per call."""

    def __init__(self, runs: int = 20, warmup: int = 3):
        self.runs, self.warmup = runs, warmup
        self._flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.runs):
            self._flush.zero_()
            torch.cuda._sleep(2_000_000)        # ~1 ms of spinning
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def host(self, fn) -> float:
        """Host milliseconds per call, enqueueing back to back."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(self.runs):
            fn()
        t = (time.perf_counter() - t0) / self.runs * 1e3
        torch.cuda.synchronize()
        return t


def bound(nbytes: float, flops: float, bw: float, fl: float):
    t_b, t_f = nbytes / bw, flops / fl
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def make_weight(k: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """Heavy-tailed random weights (a few large entries make outlier
    subtiles worth the name)."""
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    big = torch.rand((k, n), generator=gen, device="cuda") < 0.002
    return torch.where(big, w * 8.0, w)


def qmm_row(timer, name, kernel, x, qt, w_dense, m, label, peak):
    """Check one qmm call against its plain version, time it, and return
    its row. The codes are integers of at most 5 bits, exact in TF32, so
    the least time for the same function on the card is TF32 tensor-core
    products (two per k step for fp32 x, split hi + lo; one for bf16),
    as the column-strip kernel runs them: the bound of both kernels is
    those products over the TF32 peak, or the bytes. ``bound_fp32_ms``
    keeps the FLOPs over the fp32 CUDA-core peak, where the decode-width
    kernel runs them."""
    bw, fl, tc = peak
    k, n = qt.shape
    dtype = x.dtype
    y = kernel(x, qt)[:m].float()
    y_ref = qmm_ref(x, qt)[:m].float()
    torch.cuda.synchronize()
    err = (y - y_ref).abs().max().item()
    tol = TOL_QMM[dtype] * y_ref.abs().max().item()
    require(err <= tol, f"{name} {label} {dtype}: max abs err {err:.3e} > "
            f"{tol:.3e}")
    ms = timer(lambda: kernel(x, qt))
    host_ms = timer.host(lambda: kernel(x, qt))
    plain_ms = timer(lambda: qmm_ref(x, qt))
    xd = x.to(torch.float32)
    lib_ms = timer(lambda: torch.matmul(xd, w_dense))
    nbytes, flops = rl.qmm_work(m, k, n, x.element_size(), qt.subtile)
    b32_ms, _ = bound(nbytes, flops, bw, fl)
    products = rl.tensor_core_products(str(dtype).replace("torch.", ""))
    b_ms, b_by = bound(nbytes, flops * products, bw, tc)
    row = dict(kernel=name, shape=label, dtype=str(dtype).replace(
        "torch.", ""), max_abs_err=err, tol=tol, ms=ms, host_ms=host_ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        bound_fp32_ms=b32_ms)
    print(f"[kernels] {name:13s} {label:31s} {row['dtype']:8s} err={err:.2e} "
          f"(tol {tol:.1e}) ms={ms:.4f} host={host_ms:.4f} "
          f"plain={plain_ms:.4f} lib={lib_ms:.4f} ratio={ms / lib_ms:.3f} "
          f"bound={b_ms:.4f} ({b_by}) fp32-bound={b32_ms:.4f}")
    return row


def check_qmm(timer, peak, gen, rows):
    """Both qmm kernels at the main path's shapes: decode at M = 1, 4, 7
    (padded to 8) and, for the 2048 x 5632 MLP projection, M = 64 (the
    width ladder's C = 16 rung at 4 slots: eight M tiles); colstrip at
    M = 128 and 512."""
    for k, n in QMM_SHAPES:
        qt = quantize_qtensor(make_weight(k, n, gen), QMCConfig(
            rho=0.3, granularity="subtile"))
        w_dense = dequantize_qtensor(qt, torch.float32)
        ms = (1, 4, 7, 64) if (k, n) == (2048, 5632) else (1, 4, 7)
        cases = [("qmm_decode", m, qmm_decode, 8) for m in ms] + \
                [("qmm_colstrip", m, qmm_colstrip, 128) for m in (128, 512)]
        for name, m, kernel, mult in cases:
            for dtype in (torch.float32, torch.bfloat16):
                pad = -(-m // mult) * mult
                x = torch.zeros((pad, k), dtype=dtype, device="cuda")
                x[:m] = torch.randn((m, k), generator=gen,
                                    device="cuda").to(dtype)
                rows.append(qmm_row(timer, name, kernel, x, qt, w_dense, m,
                                    f"M={m} K={k} N={n}", peak))
        del qt, w_dense


def patterned_qtensor(k, n, pattern, gen):
    """Random codes whose subtiles are all inlier, all outlier, or a
    checkerboard of both (both qmm kernels pick an accumulator per
    subtile row by is_out)."""
    gr, gc = k // 8, n // 128
    ij = np.add.outer(np.arange(gr), np.arange(gc))
    mask = {"all-inlier": ij < 0, "all-outlier": ij >= 0,
            "checkerboard": ij % 2 == 1}[pattern]
    flat = mask.reshape(-1)
    n_out = int(flat.sum())
    n_in = flat.size - n_out
    pos = np.zeros(flat.size, np.int32)
    pos[~flat] = np.arange(n_in)
    pos[flat] = np.arange(n_out)

    def codes(n_sub, lo, hi):
        return torch.randint(lo, hi, (max(n_sub, 1), 8, 128), generator=gen,
                             device="cuda").to(torch.int8)

    def scale():
        return torch.rand((1, n), generator=gen, device="cuda") * 0.02 \
            + 0.002
    return QTensor(in_codes=codes(n_in, -4, 4), out_codes=codes(n_out, -16,
                                                               16),
                   stream_pos=torch.as_tensor(pos.reshape(gr, gc),
                                              device="cuda"),
                   is_out=torch.as_tensor(mask, device="cuda"),
                   scale_in=scale(), scale_out=scale(), shape=(k, n),
                   bits_in=3, bits_out=5, subtile=(8, 128))


def check_patterns(timer, peak, gen, rows):
    """The qmm kernels on all-inlier, all-outlier and checkerboard weights
    at the MLP shape, fp32 and bf16 x: decode at M = 4 (padded to 8),
    colstrip at the prefill M = 512."""
    k, n = 2048, 5632
    cases = [("qmm_decode", qmm_decode, 4, 8),
             ("qmm_colstrip", qmm_colstrip, 512, 512)]
    for pattern in ("all-inlier", "all-outlier", "checkerboard"):
        qt = patterned_qtensor(k, n, pattern, gen)
        w_dense = dequantize_qtensor(qt, torch.float32)
        for name, kernel, m, pad in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.zeros((pad, k), dtype=dtype, device="cuda")
                x[:m] = torch.randn((m, k), generator=gen,
                                    device="cuda").to(dtype)
                rows.append(qmm_row(timer, name, kernel, x, qt, w_dense, m,
                                    f"M={m} K={k} N={n} {pattern}", peak))
        del qt, w_dense


def check_empty_launch(timer):
    """An empty kernel's launch, timed as the kernels are: the device-time
    floor under any one-launch call."""
    ms = timer(empty_launch)
    host_ms = timer.host(empty_launch)
    print(f"[kernels] empty kernel launch ms={ms:.4f} host={host_ms:.4f} "
          f"(the floor under any one-launch call, same timer)")
    return dict(ms=ms, host_ms=host_ms)


def make_attn_case(lanes, *, n_kv, g, hd, page, quantized, gen,
                   poison=1e3, bf16=False):
    """A ragged case on the card: per-lane (q_start, n_new), shuffled page
    ids, the null page poisoned; with ``bf16``, q and the pages in bf16."""
    q_start = torch.tensor([a for a, _ in lanes], dtype=torch.int32,
                           device="cuda")
    n_new = torch.tensor([b for _, b in lanes], dtype=torch.int32,
                         device="cuda")
    kv_len = q_start + n_new
    live = [-(-int(L) // page) if L else 0 for L in kv_len.tolist()]
    n_tbl = max(max(live), 1) + 1
    n_pages = 1 + sum(live) + 2
    kf = torch.randn((n_pages, page, n_kv, hd), generator=gen, device="cuda")
    vf = torch.randn((n_pages, page, n_kv, hd), generator=gen, device="cuda")
    kf[0] = poison
    vf[0] = poison
    ids = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
           + 1).tolist()
    tbl = torch.zeros((len(lanes), n_tbl), dtype=torch.int32)
    for b, n in enumerate(live):
        for j in range(n):
            tbl[b, j] = ids.pop()
    cache = {"block_tbl": tbl.cuda()}
    if quantized:
        kq, ks = quantize_kv(kf)
        vq, vs = quantize_kv(vf)
        cache.update(k_pages=kq.reshape(n_pages, page, -1).contiguous(),
                     v_pages=vq.reshape(n_pages, page, -1).contiguous(),
                     k_scale_pages=ks.contiguous(),
                     v_scale_pages=vs.contiguous())
    else:
        dt = torch.bfloat16 if bf16 else torch.float32
        cache.update(
            k_pages=kf.reshape(n_pages, page, -1).to(dt).contiguous(),
            v_pages=vf.reshape(n_pages, page, -1).to(dt).contiguous())
    s = max(1, int(n_new.max()))
    q = torch.randn((len(lanes), s, n_kv * g, hd), generator=gen,
                    device="cuda")
    if bf16:
        q = q.to(torch.bfloat16)
    return q, cache, q_start, kv_len, n_new, live


def attn_cost(q, cache, q_start, n_new, live, *, n_kv, hd, page, window):
    """Bytes each input/output moves once (the pages this data's queries
    see: all live pages, or under a window those it reaches), and the QK +
    PV FLOPs of its live (unmasked) score entries."""
    b, s, h, _ = q.shape
    keys = pages = 0
    for qs, nn in zip(q_start.tolist(), n_new.tolist()):
        for t in range(nn):
            vis = qs + t + 1
            keys += min(vis, window) if window else vis
        if nn:
            lo = max(0, qs - window + 1) if window else 0
            pages += (qs + nn - 1) // page - lo // page + 1
    return rl.attention_work(
        lanes=b, s=s, n_heads=h, n_kv=n_kv, hd=hd, page=page,
        pages=pages, keys=keys, tbl_entries=cache["block_tbl"].numel(),
        q_itemsize=q.element_size(),
        kv_itemsize=cache["k_pages"].element_size(),
        kv_scaled="k_scale_pages" in cache)


def check_attention(timer, peak, gen, rows):
    """The attention kernel at the serve phase's shapes (hd 64, 32 KV
    heads, 4 lanes, page 16) over fp32, int8 and bf16 pages (bf16 q with
    bf16 pages, the arena of a bf16 model), and at hymba-1.5b's (5 KV
    heads of 25 query heads, G = 5, its 1024-token window, kv_len up to
    2048) over fp32 and bf16 pages, at dbrx-132b's (hd 128, 8 KV heads
    of 48, G = 6) over fp32 pages, where a chunk runs q blocks of 8 tokens
    (``q_block_for``), and at stablelm-3b's (hd 80, G = 1) and gemma2-2b's
    (hd 256, G = 2, window 4096, softcap 50; 32-key ring stages over fp32
    pages) over fp32, bf16 and int8 pages, against its plain version on
    the same inputs."""
    bw, fl, _ = peak
    page, b = 16, 4
    decode = [(69, 1), (192, 1), (239, 1), (0, 0)]
    # StableLM-2-1.6B's published context is 4096 tokens
    long_ctx = [(4095, 1), (3000, 1), (1500, 1), (511, 1)]
    chunk = [(0, 128), (64, 100), (200, 1), (0, 0)]
    cases = [("decode S=1", decode, 32, 1, "float32", None, None),
             ("decode S=1", decode, 32, 1, "int8", None, None),
             ("decode S=1", decode, 32, 1, "bfloat16", None, None),
             ("decode S=1 kv_len<=4096", long_ctx, 32, 1, "float32", None,
              None),
             ("decode S=1 kv_len<=4096", long_ctx, 32, 1, "int8", None,
              None),
             ("decode S=1 kv_len<=4096", long_ctx, 32, 1, "bfloat16", None,
              None),
             ("chunk S=128", chunk, 32, 1, "float32", None, None),
             ("chunk S=128", chunk, 32, 1, "int8", None, None),
             ("chunk S=128", chunk, 32, 1, "bfloat16", None, None),
             ("chunk S=128 window+softcap G=2", chunk, 16, 2, "float32", 32,
              50.0)]
    # hymba-1.5b: a decode round at kv_len 2048 and a 128-token chunk past
    # position 1024, both over its sliding window
    hymba_decode = [(2047, 1), (1800, 1), (1030, 1), (0, 0)]
    hymba_chunk = [(1100, 128), (1500, 100), (2047, 1), (0, 0)]
    for dt in ("float32", "bfloat16"):
        cases += [(HYMBA_DECODE, hymba_decode, 5, 5, dt, 1024, None),
                  (HYMBA_CHUNK, hymba_chunk, 5, 5, dt, 1024, None)]
    cases = [c + (64,) for c in cases]
    # dbrx-132b at the [moe] phase's shapes (max_len 256): a decode round
    # and a mixed chunk step over fp32 pages
    cases += [(DBRX_DECODE, [(200, 1), (150, 1), (31, 1), (0, 0)], 8, 6,
               "float32", None, None, 128),
              (DBRX_CHUNK, chunk, 8, 6, "float32", None, None, 128)]
    # stablelm-3b (32 KV heads, hd 80: a row of 5, 10 or 20 16-byte
    # chunks) at the serve phase's lanes, and gemma2-2b (4 KV heads of 8,
    # hd 256, softcap 50, its local layers' 4096-token window) decoding at
    # up to its 8192-token context and a chunk past the window
    for dt in PAGE_KINDS:
        cases += [(S3B_DECODE, decode, 32, 1, dt, None, None, 80),
                  (S3B_CHUNK, chunk, 32, 1, dt, None, None, 80),
                  (G2_DECODE, [(8191, 1), (5000, 1), (4100, 1), (0, 0)], 4,
                   2, dt, 4096, 50.0, 256),
                  (G2_CHUNK, [(4200, 128), (6000, 100), (8191, 1), (0, 0)],
                   4, 2, dt, 4096, 50.0, 256)]
    for label, lanes, n_kv, g, dt, window, cap, hd in cases:
        q, cache, qs, kl, n_new, live = make_attn_case(
            lanes, n_kv=n_kv, g=g, hd=hd, page=page,
            quantized=dt == "int8", bf16=dt == "bfloat16", gen=gen)
        kw = dict(n_kv=n_kv, head_dim=hd, window=window, attn_softcap=cap)
        q_blk = min(q_block_for(g, hd, cache["k_pages"].dtype,
                                cache["block_tbl"].shape[1], page),
                    q.shape[1])
        if label == DBRX_CHUNK:
            require(q_blk == 8, f"attention {label}: q block {q_blk}, "
                    f"expected the halved 8")
        o, m, l = ragged_paged_attention_call(q, cache, qs, kl, **kw)
        o_r, m_r, l_r = ragged_paged_attention_ref(q, cache, qs, kl, **kw)
        torch.cuda.synchronize()
        s = q.shape[1]
        pos = torch.arange(s, device="cuda")[None, :]
        valid = pos < n_new[:, None]                      # [B, S]
        require(bool((o[~valid] == 0).all()), f"attention {label}: dead "
                f"rows are not exactly 0")
        ov, orv = o[valid], o_r[valid]
        require(torch.allclose(ov, orv, atol=ATT_ATOL, rtol=ATT_RTOL),
                f"attention {label}: o differs (max abs "
                f"{(ov - orv).abs().max().item():.3e})")
        require(torch.allclose(l[valid], l_r[valid], atol=ATT_ATOL,
                               rtol=ATT_RTOL) and
                torch.allclose(m[valid], m_r[valid], atol=ATT_ATOL,
                               rtol=ATT_RTOL),
                f"attention {label}: softmax state (m, l) differs")
        err = (ov - orv).abs().max().item()
        ms = timer(lambda: ragged_paged_attention_call(q, cache, qs, kl,
                                                       **kw))
        host_ms = timer.host(lambda: ragged_paged_attention_call(
            q, cache, qs, kl, **kw))
        plain_ms = timer(lambda: ragged_paged_attention_ref(q, cache, qs,
                                                            kl, **kw))
        k_all, v_all = paged_cache_read(cache, torch.float32, n_kv, hd)
        t = k_all.shape[1]
        qh = q.transpose(1, 2)                            # [B, H, S, hd]
        kh = k_all.transpose(1, 2).repeat_interleave(g, dim=1)
        vh = v_all.transpose(1, 2).repeat_interleave(g, dim=1)
        pq = qs[:, None] + torch.arange(s, device="cuda")[None, :]
        pk = torch.arange(t, device="cuda")
        mask = ((pk[None, None, :] <= pq[..., None])
                & (pk[None, None, :] < kl[:, None, None]))
        if window is not None:
            mask = mask & (pq[..., None] - pk[None, None, :] < window)
        mask = mask[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = timer(lambda: sdpa(qh, kh, vh, attn_mask=mask))
        nbytes, flops = attn_cost(q, cache, qs, n_new, live, n_kv=n_kv,
                                  hd=hd, page=page, window=window)
        b_ms, b_by = bound(nbytes, flops, bw, fl)
        rows.append(dict(kernel="ragged_paged_attention", shape=label,
                         dtype=dt, max_abs_err=err, ms=ms,
                         host_ms=host_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         q_block=q_blk))
        print(f"[kernels] attention {label:38s} {dt:8s} q_blk={q_blk} "
              f"err={err:.2e} "
              f"ms={ms:.4f} host={host_ms:.4f} plain={plain_ms:.4f} "
              f"sdpa={lib_ms:.4f} ratio={ms / lib_ms:.3f} "
              f"bound={b_ms:.4f} ({b_by})")


def in_order(cache) -> None:
    """Renumber a case's pages in place as the engine's pool hands them
    out, lane after lane from page 1 (its FIFO free list), so that a
    lane's pages are consecutive ids and a page slice holds them in one or
    two runs."""
    tbl = cache["block_tbl"]
    old = tbl[tbl > 0]                       # lane order, then slot order
    new = torch.arange(1, old.numel() + 1, dtype=tbl.dtype,
                       device=tbl.device)
    for name in ("k_pages", "v_pages"):
        pages = cache[name]
        moved = pages[old.long()].clone()
        pages[new.long()] = moved
    cache["block_tbl"] = torch.where(tbl > 0, torch.zeros_like(tbl).
                                     masked_scatter(tbl > 0, new), tbl)


def sliced_cost(q, cache, q_start, n_new, page_slice, *, n_kv, hd, page,
                window=None):
    """``attn_cost`` of one data rank's call: the live pages whose table
    entry lies in its slice (under a window, those the window reaches),
    and the score entries of their keys."""
    first, n = page_slice
    tbl = cache["block_tbl"].tolist()
    b, s, h, _ = q.shape
    keys = pages = 0
    for lane, (qs, nn) in enumerate(zip(q_start.tolist(), n_new.tolist())):
        if not nn:
            continue
        owned = [first <= e < first + n for e in tbl[lane]]
        lo = max(0, qs - window + 1) if window else 0
        pages += sum(owned[p] for p in range(lo // page,
                                             (qs + nn - 1) // page + 1))
        for t in range(nn):
            pos = qs + t
            start = max(0, pos - window + 1) if window else 0
            keys += sum(min(pos, p * page + page - 1)
                        - max(start, p * page) + 1
                        for p in range(start // page, pos // page + 1)
                        if owned[p])
    return rl.attention_work(
        lanes=b, s=s, n_heads=h, n_kv=n_kv, hd=hd, page=page, pages=pages,
        keys=keys, tbl_entries=cache["block_tbl"].numel(),
        q_itemsize=q.element_size(),
        kv_itemsize=cache["k_pages"].element_size(),
        kv_scaled="k_scale_pages" in cache)


def check_sliced_attention(timer, peak, gen, rows):
    """The attention kernel over a data rank's page slice at the serve
    phase's shapes (stablelm-1.6b: 32 KV heads, hd 64, page 16; decode
    lanes and the S = 128 chunk) and at hymba-1.5b's decode (5 KV heads of
    25, G = 5, window 1024, kv_len up to 2048), pages numbered as the
    engine's pool hands them out, the arena cut into D = 2 slices: each
    slice's call against the sliced plain version, its time, the plain
    version's and SDPA's on the slice's keys (yardstick), its bound; the
    two slices merged (``merge_slices``, timed) against the call over the
    whole arena."""
    bw, fl, _ = peak
    page, hd = 16, 64
    decode = [(69, 1), (192, 1), (239, 1), (0, 0)]
    chunk = [(0, 128), (64, 100), (200, 1), (0, 0)]
    hymba = [(2047, 1), (1800, 1), (1030, 1), (0, 0)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, lanes, n_kv, g, window in (
            (SLICED_DECODE, decode, 32, 1, None),
            (SLICED_CHUNK, chunk, 32, 1, None),
            (SLICED_HYMBA, hymba, 5, 5, 1024)):
        q, cache, qs, kl, n_new, _ = make_attn_case(
            lanes, n_kv=n_kv, g=g, hd=hd, page=page, quantized=False,
            gen=gen)
        in_order(cache)
        kw = dict(n_kv=n_kv, head_dim=hd, window=window)
        n_pages = cache["k_pages"].shape[0]
        half = n_pages // 2
        slices = [(0, half), (half, n_pages - half)]
        parts, per = [], []
        for first, n in slices:
            local = {k: (v[first:first + n].contiguous()
                         if k.endswith("_pages") else v)
                     for k, v in cache.items()}
            kws = dict(kw, page_slice=(first, n))
            o, m, l = ragged_paged_attention_call(q, local, qs, kl, **kws)
            o_r, m_r, l_r = ragged_paged_attention_ref(q, local, qs, kl,
                                                       **kws)
            torch.cuda.synchronize()
            live = l_r > 0
            require(bool((o[~live] == 0).all() and (m[~live] == -1e30).all()
                         and (l[~live] == 0).all()),
                    f"attention {label}: rows with no key in the slice are "
                    f"not exactly (0, -1e30, 0)")
            require(torch.allclose(o[live], o_r[live], atol=ATT_ATOL,
                                   rtol=ATT_RTOL)
                    and torch.allclose(l[live], l_r[live], atol=ATT_ATOL,
                                       rtol=ATT_RTOL),
                    f"attention {label}: slice {first} differs from the "
                    f"sliced plain version")
            err = (o[live] - o_r[live]).abs().max().item()
            ms = timer(lambda: ragged_paged_attention_call(q, local, qs, kl,
                                                           **kws))
            plain_ms = timer(lambda: ragged_paged_attention_ref(
                q, local, qs, kl, **kws))
            # SDPA over the slice's keys: the masked gather of its pages
            own = ((cache["block_tbl"] >= first)
                   & (cache["block_tbl"] < first + n))
            tbl_l = torch.where(own, cache["block_tbl"] - first,
                                torch.zeros_like(cache["block_tbl"]))
            k_all, v_all = paged_cache_read(dict(local, block_tbl=tbl_l),
                                            torch.float32, n_kv, hd)
            t = k_all.shape[1]
            qh = q.transpose(1, 2)
            kh = k_all.transpose(1, 2).repeat_interleave(g, dim=1)
            vh = v_all.transpose(1, 2).repeat_interleave(g, dim=1)
            pq = qs[:, None] + torch.arange(q.shape[1], device="cuda")[None]
            pk = torch.arange(t, device="cuda")
            mask = ((pk[None, None, :] <= pq[..., None])
                    & (pk[None, None, :] < kl[:, None, None])
                    & own.repeat_interleave(page, dim=1)[:, None, :])
            if window is not None:
                mask = mask & (pq[..., None] - pk[None, None, :] < window)
            lib_ms = timer(lambda: sdpa(qh, kh, vh, attn_mask=mask[:, None]))
            nbytes, flops = sliced_cost(q, cache, qs, n_new, (first, n),
                                        n_kv=n_kv, hd=hd, page=page,
                                        window=window)
            b_ms, b_by = bound(nbytes, flops, bw, fl)
            per.append(dict(first=first, pages=n, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                            max_abs_err=err))
            parts.append((o, m, l))
        whole, _, _ = ragged_paged_attention_call(q, cache, qs, kl, **kw)
        merged = merge_slices(parts)
        valid = torch.arange(q.shape[1], device="cuda")[None] < n_new[:, None]
        require(torch.allclose(merged[valid], whole[valid], atol=ATT_ATOL,
                               rtol=ATT_RTOL),
                f"attention {label}: the merged slices differ from the "
                f"whole-arena call")
        merge_ms = timer(lambda: merge_slices(parts))
        slow = max(per, key=lambda r: r["ms"])
        rows.append(dict(kernel="ragged_paged_attention", shape=label,
                         dtype="float32", max_abs_err=max(
                             r["max_abs_err"] for r in per),
                         ms=slow["ms"], host_ms=None,
                         plain_ms=max(r["plain_ms"] for r in per),
                         library_ms=max(r["library_ms"] for r in per),
                         bound_ms=max(r["bound_ms"] for r in per),
                         bound_by=max(per, key=lambda r: r["bound_ms"])[
                             "bound_by"], merge_ms=merge_ms, slices=per))
        for r in per:
            print(f"[kernels] attention {label} slice [{r['first']}, "
                  f"+{r['pages']}) err={r['max_abs_err']:.2e} "
                  f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
                  f"sdpa={r['library_ms']:.4f} bound={r['bound_ms']:.4f} "
                  f"({r['bound_by']})")
        print(f"[kernels] attention {label}: merge of the 2 slices "
              f"{merge_ms:.4f} ms; merged = whole-arena call")


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path at full width
# ---------------------------------------------------------------------------
def make_requests(cfg, n: int, seed: int):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(64, 193))
        reqs.append(Request(uid=i, prompt=rng.integers(
            2, cfg.vocab, size=plen).astype(np.int32),
            max_new_tokens=int(rng.integers(16, 49))))
    return reqs


# the three serve runs: (a) eager, (b) graphed, (c) graphed + pipelined
SERVE_RUNS = [("a eager", dict(cuda_graphs=False)),
              ("b graphed", dict(cuda_graphs=True)),
              ("c graphed+pipelined", dict(cuda_graphs=True,
                                           pipelined=True))]


def serve_engine(cfg, qparams, **kw):
    return ServeEngine(cfg, qparams, slots=4, max_len=256,
                       paged_attention=True, weight_plan=False,
                       device="cuda", **kw)


def serve(cfg, qparams, seed: int, label: str, kernels=SERVE_KERNELS,
          ref_per_call: int = 0, tag: str = "serve", **kw):
    """One serve configuration on 8 requests: a first run (the graphs are
    captured there), then the measured run of the same requests, with the
    launch counts set to 0 just before it and read just after. Each of
    ``kernels`` must have launched; qmm's "ref" path must have run exactly
    ``ref_per_call`` times a step call (the QTensor leaves ``qmm_plan``
    sends there), so never on a model whose every stream tiles."""
    eng = serve_engine(cfg, qparams, **kw)
    eng.run(make_requests(cfg, 8, seed))
    torch.cuda.synchronize()
    first = eng.stats
    reqs = make_requests(cfg, 8, seed)
    build.reset_launches()
    kops.reset_path_counts()
    eng.run(reqs)
    torch.cuda.synchronize()
    launches = dict(build.launches)
    paths = dict(kops.path_counts)
    s = eng.stats
    for r in reqs:
        require(len(r.out_tokens) == r.max_new_tokens,
                f"{label}: request {r.uid} emitted {len(r.out_tokens)} of "
                f"{r.max_new_tokens} tokens")
        require(DEAD_TOKEN not in r.out_tokens and all(
            0 <= t < cfg.vocab for t in r.out_tokens),
            f"{label}: request {r.uid} emitted an impossible token")
    for k in kernels:
        require(launches[k] > 0, f"{label}: kernel {k} never launched on "
                f"the serving path")
    ref_want = ref_per_call * s.rounds
    require(paths["ref"] == ref_want, f"{label}: qmm took the plain 'ref' "
            f"path {paths['ref']} times on the serving path, where "
            f"qmm_plan sends {ref_per_call} calls a step x {s.rounds} "
            f"rounds = {ref_want}")
    sset = eng.step_set
    surface = len(sset.step.widths)
    captures = first.graph_captures + s.graph_captures
    require(sset.step.captures <= surface
            and sset.solo_step.captures <= surface,
            f"{label}: {sset.step.captures} step / {sset.solo_step.captures} "
            f"solo captures past the declared surface of {surface} widths")
    if kw.get("cuda_graphs"):
        require(s.graph_replays > 0 and s.graph_captures == 0,
                f"{label}: the measured run captured {s.graph_captures} "
                f"graphs and replayed {s.graph_replays}")
    ttft = float(np.percentile(s.ttft_s, 50)) * 1e3
    round_ms = np.asarray(s.step_seconds) * 1e3
    print(f"[{tag}] {label}: {s.tokens_out} tokens, {s.rounds} rounds "
          f"({s.prefill_chunks} prefill chunks, {s.decode_steps} decode "
          f"rounds), {s.wall_s:.3f}s, {s.tokens_per_s:.1f} tok/s, round ms "
          f"p50 {np.median(round_ms):.2f} max {round_ms.max():.2f} (wall "
          f"per round {s.wall_s / s.rounds * 1e3:.2f}), TTFT "
          f"p50 {ttft:.1f} ms, preemptions {s.preemptions}")
    print(f"[{tag}] {label}: graphs captured {captures} (of a surface of "
          f"{surface} widths x 2 callables; {first.capture_s:.2f}s), "
          f"replays {s.graph_replays}, graph pool {sset.pool_bytes} bytes; "
          f"solo rounds {s.solo_rounds}, pipelined {s.pipelined_rounds}, "
          f"drains {s.pipeline_barriers}, lag-trimmed tokens "
          f"{s.lag_trimmed_tokens}; first run {first.tokens_per_s:.1f} "
          f"tok/s")
    print(f"[{tag}] {label}: kernel launches {launches}; qmm paths {paths}"
          + (f" (ref = {ref_per_call} K % 128 != 0 leaf calls a step x "
             f"{s.rounds} rounds, as qmm_plan predicts)" if ref_per_call
             else ""))
    out = dict(tokens=s.tokens_out, rounds=s.rounds, wall_s=s.wall_s,
               tokens_per_s=s.tokens_per_s, ttft_p50_ms=ttft,
               round_ms_p50=float(np.median(round_ms)),
               round_ms_max=float(round_ms.max()),
               first_run_tokens_per_s=first.tokens_per_s,
               graph_captures=captures, capture_s=first.capture_s,
               graph_replays=s.graph_replays, pool_bytes=sset.pool_bytes,
               solo_rounds=s.solo_rounds,
               pipelined_rounds=s.pipelined_rounds,
               pipeline_barriers=s.pipeline_barriers,
               lag_trimmed_tokens=s.lag_trimmed_tokens,
               launches=launches, qmm_paths=paths)
    return out, [r.out_tokens for r in reqs], eng


def check_no_host_sync(eng, samp=None, tag="serve"):
    """One eager step of the step set under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in the step may
    read the device from the host (what stream capture forbids). Every
    lane idle, so it writes only the null page; with ``samp`` (a lane
    table with sampled lanes seated, the table's block rows all null),
    lane 0 runs one token through the sampled head, its K/V on the null
    page too."""
    sset = eng.step_set
    z = np.zeros(sset.max_slots, np.int32)
    n_new = z.copy()
    if samp is None:
        samp = samplib.lane_inputs(sset.max_slots)
    else:
        n_new[0] = 1
        require(not eng._pool.block_tables.any(), "check_no_host_sync: "
                "a slot still maps pages")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sset.step(eng._exec_params, np.zeros((sset.max_slots, 1), np.int32),
                  eng._arena, z, n_new, samp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[{tag}{'' if n_new[0] == 0 else '-x'}] one eager step "
          f"{'' if n_new[0] == 0 else 'with sampled lanes seated '}under "
          f"set_sync_debug_mode('error'): no read of the device from the "
          f"host")


def decode_requests(cfg, seed: int):
    """4 requests of 8 prompt tokens and 48 new ones: one short prefill
    round, then a steady window of 4-lane decode rounds."""
    rng = np.random.default_rng(seed + 1)
    return [Request(uid=i, prompt=rng.integers(2, cfg.vocab, size=8).astype(
        np.int32), max_new_tokens=48) for i in range(4)]


def idle_share(eng, cfg, seed: int, label: str, top: int = 6,
               tag: str = "idle"):
    """The device's idle share over a steady decode window of this engine
    (warm: a first run captures what it needs): ``torch.profiler`` with
    CPU and CUDA activity; busy = the union of the device activity
    intervals, idle = 1 - busy / the run's wall time. The profiler's host
    tracing slows the host, so the same window is also run without it,
    and its wall time gives a second share from the same busy time. If
    the profiler shows no device activity, CUDA events time the C = 1 step
    instead (busy = decode rounds x its device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.run(decode_requests(cfg, seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(decode_requests(cfg, seed))
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    plain_p50 = float(np.median(eng.stats.step_seconds) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(decode_requests(cfg, seed))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    s = eng.stats
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy = 0.0
    cur0 = cur1 = None
    for a, b in spans:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        busy += cur1 - cur0
    source = "torch.profiler"
    if busy <= 0:
        print(f"[{tag}] {label}: the profiler shows no device time; timing "
              f"the C = 1 step with CUDA events instead")
        source = "cuda events"
        sset = eng.step_set
        z = np.zeros(sset.max_slots, np.int32)
        args = (eng._exec_params, np.zeros((sset.max_slots, 1), np.int32),
                eng._arena, z, z + 0, samplib.lane_inputs(sset.max_slots))
        sset.step(*args)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            sset.step(*args)
        b.record()
        b.synchronize()
        busy = a.elapsed_time(b) / 20 * 1e3 * s.rounds
    kern = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kern[e.key] = kern.get(e.key, 0.0) + e.self_device_time_total
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:top]
    share = 1.0 - busy / wall_us
    plain_share = 1.0 - busy / plain_wall_us
    print(f"[{tag}] {label}: {s.rounds} rounds ({s.decode_steps} decode) in "
          f"{wall_us / 1e3:.2f} ms under the profiler, device busy "
          f"{busy / 1e3:.2f} ms ({source}), idle share {share:.4f}, round "
          f"ms p50 {np.median(s.step_seconds) * 1e3:.2f}; without the "
          f"profiler {plain_wall_us / 1e3:.2f} ms, round ms p50 "
          f"{plain_p50:.2f}, idle share {plain_share:.4f}")
    for name, us in top:
        print(f"[{tag}] {label}:   {us / 1e3:9.3f} ms  {name[:90]}")
    return dict(rounds=s.rounds, wall_ms=wall_us / 1e3,
                busy_ms=busy / 1e3, idle_share=share, source=source,
                round_ms_p50=float(np.median(s.step_seconds) * 1e3),
                plain_wall_ms=plain_wall_us / 1e3,
                plain_round_ms_p50=plain_p50, plain_idle_share=plain_share,
                top_kernels_ms={k: v / 1e3 for k, v in top})


def serve_phase(cfg, qparams, seed: int):
    """(a), (b) and (c) on the same 8 requests, identical tokens required;
    the idle share of (a) and (b) over a steady decode window."""
    out, toks, idle = {}, {}, {}
    for label, kw in SERVE_RUNS:
        out[label], toks[label], eng = serve(cfg, qparams, seed, label,
                                             **kw)
        if label.startswith("a"):
            check_no_host_sync(eng)
        if not label.startswith("c"):
            idle[label] = idle_share(eng, cfg, seed, label)
        del eng
        torch.cuda.empty_cache()
    ref = toks[SERVE_RUNS[0][0]]
    for label, _ in SERVE_RUNS[1:]:
        require(toks[label] == ref, f"serve: {label} tokens differ from "
                f"the eager run's")
    print("[serve] identical tokens in the eager, graphed and "
          "graphed+pipelined runs")
    return dict(runs=out, idle=idle), ref


# ---------------------------------------------------------------------------
# phase 4s: sharded serving over gloo ranks on the one card
# ---------------------------------------------------------------------------
def gloo_probe(mesh) -> dict:
    """Which collectives gloo runs on CUDA tensors here: all_reduce with
    each op the mesh path uses, on each dtype it reduces, over the data
    group; broadcast, all_gather, reduce_scatter_tensor and
    all_gather_into_tensor beside them. Serving uses all_reduce only;
    training (launch/collectives.py) all_reduce SUM and MAX,
    reduce_scatter_tensor and all_gather_into_tensor on float32,
    whatever this probe finds: nothing switches on it."""
    import torch.distributed as dist
    group = mesh.groups["data"]
    out = {}
    for dt in (torch.float32, torch.int32, torch.int64, torch.uint8):
        for op in ("sum", "max", "min"):
            t = torch.full((5,), mesh.rank + 1, dtype=dt, device="cuda")
            try:
                mesh.all_reduce(t, "data", op)
                out[f"all_reduce {op} {dt}"] = t[0].item()
            except Exception as exc:       # noqa: BLE001
                out[f"all_reduce {op} {dt}"] = f"refused: {exc}"[:120]
    t = torch.full((4,), float(mesh.rank), device="cuda")
    both = torch.empty(8, device="cuda")
    half = torch.empty(2, device="cuda")
    for name, call in (
            ("broadcast", lambda: dist.broadcast(t, 0, group=group)),
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(t) for _ in range(2)], t, group=group)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                half, t, group=group)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                both, t, group=group))):
        try:
            call()
            out[name] = "ok"
        except Exception as exc:           # noqa: BLE001
            out[name] = f"refused: {exc}"[:120]
    torch.cuda.synchronize()
    out["training uses"] = ("all_reduce sum/max, reduce_scatter_tensor "
                            "sum, all_gather_into_tensor; float32")
    return out


def mesh_rank(mesh, job):
    """One gloo rank of the mesh phase on the card: its weights (the
    serve phase's streams as they are, or its own TP shard of the dense
    weights quantized here and held against the whole conversion's shard
    bit for bit), then the serve phase's 8 requests through
    ``ServeEngine(mesh=...)`` once (eager: nothing to capture), with the
    launch counts set to 0 just before and the collectives counted over
    it. Prints nothing."""
    t_rank = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    out = {"rank": mesh.rank, "coords": mesh.coords}
    if job.get("probe"):
        out["probe"] = gloo_probe(mesh)
    if "qparams" in job:
        params = job["qparams"]
    else:
        m = mesh.index("model")
        t0 = time.monotonic()
        params = quantize_for_serving(
            job["dense"], QMCConfig(rho=0.3, granularity="subtile"),
            min_dim=64, tp_shards=mesh.shape[1], only_shard=m)
        torch.cuda.synchronize()
        out["ptq_s"] = time.monotonic() - t0
        same = differ = 0
        for own, whole in zip(qtensors_and_shards(params),
                              qtensors_and_shards(job["whole"])):
            if isinstance(own, ShardedQTensor):
                a, b = own.local(m), whole.local(m)
                ok = all(torch.equal(getattr(a, f), getattr(b, f))
                         for f in ("in_codes", "out_codes", "stream_pos",
                                   "is_out", "scale_in", "scale_out"))
                same, differ = same + ok, differ + (not ok)
        out["shards_equal"], out["shards_differ"] = same, differ
    cfg = job["cfg"]
    eng = ServeEngine(cfg, params, slots=4, max_len=256,
                      paged_attention=True, device="cuda", mesh=mesh,
                      cuda_graphs=False)
    reqs = job["requests"]
    out["setup_s"] = time.monotonic() - t_rank
    build.reset_launches()
    kops.reset_path_counts()
    c0, cs0 = mesh.collectives, mesh.collective_seconds
    eng.run(reqs)
    torch.cuda.synchronize()
    st = eng.stats
    out.update(tokens=[r.out_tokens for r in reqs],
               launches=dict(build.launches), paths=dict(kops.path_counts),
               rounds=st.rounds, tokens_out=st.tokens_out, wall_s=st.wall_s,
               tokens_per_s=st.tokens_per_s,
               round_ms_p50=float(np.median(st.step_seconds) * 1e3),
               collectives=mesh.collectives - c0,
               collective_s=mesh.collective_seconds - cs0,
               rank_s=time.monotonic() - t_rank)
    return out


def qtensors_and_shards(tree):
    """The stream leaves of a parameter tree, in walk order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from qtensors_and_shards(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from qtensors_and_shards(v)
    elif isinstance(tree, (QTensor, ShardedQTensor)):
        yield tree


def mesh_phase(cfg, qparams, seed: int, greedy_tokens) -> dict:
    """Sharded serving on gloo ranks sharing the card (NCCL refuses two
    ranks on one device; gloo moves every collective through host
    memory, so these times say nothing of NVLink): (2, 1) on the serve
    phase's streams must give exactly its greedy tokens; (1, 2) and
    (2, 2) on tp_shards = 2 streams, each rank quantizing its own shard
    (equal to the whole conversion's shard bit for bit), must give the
    same tokens as each other and as one process serving the whole
    2-shard conversion (weight plan: its streams dequantized once), on 4
    of the serve phase's prompts with 12 new tokens each. (1, 2) is plain
    TP: B1 over the whole arena on a rank's heads, no page-slice merge,
    COW copies local. Every
    rank launches B1, B2 and B3 and never qmm's "ref" path; a rank that
    raises or hangs fails the phase (``launch.mesh.spawn``)."""
    out = {}
    t_phase = time.monotonic()

    def run(shape, job):
        t0 = time.monotonic()
        res = spawn(mesh_rank, shape, backend="gloo", args=(job,),
                    timeout_s=400.0)
        label = f"({shape[0]},{shape[1]})"
        for r in res:
            for k in SERVE_KERNELS:
                require(r["launches"][k] > 0, f"mesh {label} rank "
                        f"{r['rank']}: kernel {k} never launched")
            require(r["paths"]["ref"] == 0, f"mesh {label} rank "
                    f"{r['rank']}: qmm took its 'ref' path")
            require(r["tokens"] == res[0]["tokens"], f"mesh {label}: rank "
                    f"{r['rank']}'s tokens differ from rank 0's")
        r0 = res[0]
        per_round = r0["collectives"] / r0["rounds"]
        print(f"[mesh] {label} gloo, {len(res)} ranks on one card: "
              f"{r0['tokens_out']} tokens, {r0['rounds']} rounds, "
              f"{r0['wall_s']:.3f}s, {r0['tokens_per_s']:.1f} tok/s, round "
              f"ms p50 {r0['round_ms_p50']:.2f}; rank 0: "
              f"{r0['collectives']} collectives ({per_round:.1f} a round) "
              f"in {r0['collective_s']:.3f}s "
              f"({r0['collective_s'] / r0['rounds'] * 1e3:.2f} ms a "
              f"round); launches {r0['launches']}; qmm paths "
              f"{r0['paths']}; rank 0 set-up {r0['setup_s']:.1f}s, in all "
              f"{r0['rank_s']:.1f}s; spawn to join "
              f"{time.monotonic() - t0:.1f}s")
        out[label] = dict(res[0], ranks=len(res),
                          seconds=time.monotonic() - t0,
                          tokens=None)
        return res

    res = run((2, 1), dict(cfg=cfg, qparams=qparams, probe=True,
                           requests=make_requests(cfg, 8, seed)))
    probe = res[0]["probe"]
    print(f"[mesh] gloo on CUDA tensors: {probe}")
    out["gloo_probe"] = probe
    for r in res:
        require(r["tokens"] == greedy_tokens, f"mesh (2,1) rank "
                f"{r['rank']}: tokens differ from the serve phase's")
    print("[mesh] (2,1) on the serve phase's streams: every rank's tokens "
          "equal the serve phase's greedy tokens")

    dense = init_params(cfg, seed, device="cuda")
    qmc = QMCConfig(rho=0.3, granularity="subtile")
    t0 = time.monotonic()
    whole = quantize_for_serving(dense, qmc, min_dim=64, tp_shards=2)
    torch.cuda.synchronize()
    n_sqt = sum(isinstance(q, ShardedQTensor)
                for q in qtensors_and_shards(whole))
    print(f"[mesh] tp_shards=2 conversion of the whole model in "
          f"{time.monotonic() - t0:.1f}s: {n_sqt} 2-shard leaves")
    n_qt = sum(1 for _ in qtensors_and_shards(qparams))
    require(n_sqt == n_qt, f"mesh: {n_sqt} 2-shard leaves, expected every "
            f"one of the {n_qt} stream leaves")
    # 4 of the serve phase's prompts, 12 new tokens each (a round of the
    # (2, 2) mesh costs ~100 gloo collectives through host memory)
    reqs = make_requests(cfg, 4, seed)
    for r in reqs:
        r.max_new_tokens = 12
    t0 = time.monotonic()
    one = ServeEngine(cfg, whole, slots=4, max_len=256,
                      paged_attention=True, weight_plan=True,
                      cuda_graphs=False, device="cuda")
    ref_reqs = [dataclasses.replace(r, out_tokens=[]) for r in reqs]
    one.run(ref_reqs)
    ref2 = [r.out_tokens for r in ref_reqs]
    print(f"[mesh] one process on the whole tp_shards=2 conversion (its "
          f"streams dequantized once): {one.stats.tokens_out} tokens in "
          f"{time.monotonic() - t0:.1f}s")
    del one
    torch.cuda.empty_cache()
    for shape in ((1, 2), (2, 2)):
        res = run(shape, dict(cfg=cfg, dense=dense, whole=whole,
                              requests=reqs))
        for r in res:
            require(r["shards_differ"] == 0 and r["shards_equal"] == n_sqt,
                    f"mesh {shape} rank {r['rank']}: its own shard's "
                    f"streams differ from the whole conversion's "
                    f"({r['shards_differ']} of {n_sqt})")
            require(r["tokens"] == ref2, f"mesh {shape} rank {r['rank']}: "
                    f"tokens differ from one process on the same streams")
        print(f"[mesh] {shape}: every rank quantized its own shard "
              f"({res[0]['ptq_s']:.1f}s on rank 0; {n_sqt} leaves equal to "
              f"the whole conversion's) and gave the tokens of one process "
              f"on the same streams")
    del dense, whole
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_phase
    print(f"[mesh] phase {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 4x: sampled lanes, the prefix cache with dedup, speculative decode
# ---------------------------------------------------------------------------
HOT = dict(temperature=0.8, top_k=50, top_p=0.95)


def counted_run(eng, reqs, cfg, label):
    """One run with the launch counts set to 0 just before it and read
    just after: every serving kernel launched, qmm's "ref" path never,
    every token a vocab id, captures within the step set's surface."""
    build.reset_launches()
    kops.reset_path_counts()
    eng.run(reqs)
    torch.cuda.synchronize()
    launches = dict(build.launches)
    paths = dict(kops.path_counts)
    for k in SERVE_KERNELS:
        require(launches[k] > 0, f"{label}: kernel {k} never launched")
    require(paths["ref"] == 0, f"{label}: qmm took the plain 'ref' path "
            f"{paths['ref']} times")
    for r in reqs:
        require(r.done and r.out_tokens and DEAD_TOKEN not in r.out_tokens
                and all(0 <= t < cfg.vocab for t in r.out_tokens),
                f"{label}: request {r.uid} emitted an impossible token")
    sset = eng.step_set
    for fn in (sset.step, sset.solo_step):
        require(fn.captures <= fn.surface, f"{label}: {fn.name} captured "
                f"{fn.captures} graphs past its surface of {fn.surface}")
    s = eng.stats
    ttft = float(np.percentile(s.ttft_s, 50)) * 1e3
    print(f"[serve-x] {label}: {s.tokens_out} tokens, {s.rounds} rounds, "
          f"{s.wall_s:.3f}s, {s.tokens_per_s:.1f} tok/s, TTFT p50 "
          f"{ttft:.1f} ms, graphs captured {s.graph_captures} (step "
          f"{sset.step.captures}, solo {sset.solo_step.captures}), replays "
          f"{s.graph_replays}; launches {launches}; qmm paths {paths}")
    return dict(tokens=[r.out_tokens for r in reqs], tokens_out=s.tokens_out,
                rounds=s.rounds, wall_s=s.wall_s,
                tokens_per_s=s.tokens_per_s, ttft_p50_ms=ttft,
                graph_captures=s.graph_captures,
                graph_replays=s.graph_replays, launches=launches,
                qmm_paths=paths)


def sampled_requests(cfg, seed: int):
    """The serve phase's 8 requests: uids 0, 2, 4, 6 sample (HOT, a seed
    each), uid 1 samples with top_k 1 (greedy at any temperature), the
    rest are greedy."""
    reqs = make_requests(cfg, 8, seed)
    for r in reqs:
        if r.uid % 2 == 0:
            r.sampling = SamplingParams(seed=1000 + r.uid, **HOT)
        elif r.uid == 1:
            r.sampling = SamplingParams(temperature=0.8, top_k=1, seed=1001)
    return reqs


def sampled_lanes(cfg, qparams, seed: int, greedy_tokens, pool_b: int):
    """Sampled lanes graphed (twice), alone through the solo step, and
    eagerly: identical streams; top_k 1 equals the greedy run (a)."""
    eng = serve_engine(cfg, qparams, cuda_graphs=True)
    first = counted_run(eng, sampled_requests(cfg, seed), cfg,
                        "sampled graphed, run 1")
    second = counted_run(eng, sampled_requests(cfg, seed), cfg,
                         "sampled graphed, run 2")
    require(second["tokens"] == first["tokens"], "sampled: two graphed "
            "runs drew different tokens")
    require(second["graph_captures"] == 0 and second["graph_replays"] > 0,
            "sampled: the second graphed run captured graphs")
    pool_bytes = eng.step_set.pool_bytes
    # a sampled request whose prompt takes a rung of M % 128 == 0 alone
    alone = next(r for r in sampled_requests(cfg, seed)
                 if r.uid % 2 == 0 and len(r.prompt) > 64)
    solo = counted_run(eng, [alone], cfg, f"sampled graphed, uid "
                       f"{alone.uid} alone")
    require(eng.stats.solo_rounds == eng.stats.rounds,
            "sampled: a lone request ran a batched round")
    require(solo["tokens"][0] == first["tokens"][alone.uid],
            f"sampled: uid {alone.uid} alone drew other tokens than "
            f"batched")
    del eng
    torch.cuda.empty_cache()
    eager = serve_engine(cfg, qparams, cuda_graphs=False)
    plain = counted_run(eager, sampled_requests(cfg, seed), cfg,
                        "sampled eager")
    require(plain["tokens"] == first["tokens"], "sampled: eager tokens "
            "differ from the graphed run's")
    table = samplib.lane_inputs(eager.slots)
    for lane, r in enumerate(sampled_requests(cfg, seed)[:eager.slots]):
        samplib.set_lane(table, lane, r.sampling, r.uid)
    check_no_host_sync(eager, table)
    del eager
    torch.cuda.empty_cache()
    require(first["tokens"][1] == greedy_tokens[1],
            "sampled: the top_k 1 request differs from its greedy tokens")
    differ = [u for u in (0, 2, 4, 6)
              if first["tokens"][u] != greedy_tokens[u]]
    require(bool(differ), "sampled: every sampled request drew its greedy "
            "tokens")
    print(f"[serve-x] sampled: identical tokens graphed twice, eagerly and "
          f"(uid {alone.uid}) alone; top_k 1 = greedy; sampled uids "
          f"{differ} differ from greedy; graph pool {pool_bytes} bytes "
          f"with sampled lanes, {pool_b} greedy (b)")
    return dict(graphed=first, graphed_again=second, solo=solo,
                eager=plain, pool_bytes=pool_bytes, pool_bytes_b=pool_b,
                differ_from_greedy=differ)


def prefix_requests(cfg, seed: int, extra: bool = False):
    """A pair of identical page-aligned 160-token prompts first (the
    second admission aliases the first's pages and COWs the last), then 8
    requests of one shared 128-token prefix (8 full pages) and a 16-64
    token suffix each. ``extra`` appends one more request of the shared
    prefix and a new 64-token suffix: on a cache that holds every page of
    the others, its suffix is the only prefill of 32 tokens or more, the
    rounds that keep the column-strip qmm (M = 4 x C, C >= 32) on the
    path."""
    rng = np.random.default_rng(seed + 2)
    pair = rng.integers(2, cfg.vocab, 160).astype(np.int32)
    shared = rng.integers(2, cfg.vocab, 128)
    reqs = [Request(uid=i, prompt=pair.copy(), max_new_tokens=24)
            for i in range(2)]
    for i in range(8):
        suffix = rng.integers(2, cfg.vocab, int(rng.integers(16, 65)))
        reqs.append(Request(uid=2 + i, prompt=np.concatenate(
            [shared, suffix]).astype(np.int32), max_new_tokens=24))
    if extra:
        suffix = np.random.default_rng(seed + 5).integers(2, cfg.vocab, 64)
        reqs.append(Request(uid=10, prompt=np.concatenate(
            [shared, suffix]).astype(np.int32), max_new_tokens=24))
    return reqs


def prefix_cache_runs(cfg, qparams, seed: int):
    """prefix_cache=False (in-flight dedup shares the pair) against
    prefix_cache=True, twice on one engine (the second run, the same
    requests and the extra one, hits the persisted index on every
    admission): identical greedy tokens throughout."""
    eng = serve_engine(cfg, qparams, cuda_graphs=True)
    counted_run(eng, prefix_requests(cfg, seed), cfg,
                "prefix_cache=False, warm-up (captures)")
    off = counted_run(eng, prefix_requests(cfg, seed), cfg,
                      "prefix_cache=False")
    s_off = eng.stats
    require(s_off.dedup_hits >= 1 and s_off.cow_copies >= 1,
            f"prefix: the uncached run deduplicated {s_off.dedup_hits} "
            f"admissions with {s_off.cow_copies} COW copies")
    off.update(dedup_hits=s_off.dedup_hits, cow_copies=s_off.cow_copies,
               prefill_tokens=s_off.prefill_tokens,
               prompt_tokens=s_off.prompt_tokens)
    del eng
    torch.cuda.empty_cache()
    eng = serve_engine(cfg, qparams, cuda_graphs=True, prefix_cache=True)
    # capture the widths both measured runs take, then empty the index:
    # run 1 starts from a cold cache on warm graphs
    for extra in (False, True):
        eng.run(prefix_requests(cfg, seed, extra))
    eng.prefix_cache.clear()
    require(len(eng.prefix_cache) == 0 and eng._pool.free_count
            == eng._pool.n_pages, "prefix: the index kept pages after clear")
    runs = {}
    for label, extra in (("prefix_cache=True, run 1", False),
                         ("prefix_cache=True, run 2", True)):
        reqs = prefix_requests(cfg, seed, extra)
        r = counted_run(eng, reqs, cfg, label)
        s = eng.stats
        require(r["tokens"][:len(off["tokens"])] == off["tokens"],
                f"prefix: {label} tokens differ from the uncached run's")
        require(s.cache_hit_tokens > 0 and s.cow_copies >= 1,
                f"prefix: {label} adopted {s.cache_hit_tokens} tokens with "
                f"{s.cow_copies} COW copies")
        require(s.prefill_tokens < off["prefill_tokens"],
                f"prefix: {label} prefilled {s.prefill_tokens} tokens, "
                f"the uncached run {off['prefill_tokens']}")
        r.update(requests=len(reqs), cache_hits=s.cache_hits,
                 hit_tokens=s.cache_hit_tokens, dedup_hits=s.dedup_hits,
                 cow_copies=s.cow_copies, evictions=s.cache_evictions,
                 hit_rate=s.hit_rate, prefill_tokens=s.prefill_tokens,
                 prefill_token_reduction=s.prefill_token_reduction)
        runs[label] = r
        print(f"[serve-x] {label}: {s.cache_hits} hits of {len(reqs)} "
              f"admissions, hit rate {s.hit_rate:.4f}, prefill tokens "
              f"{s.prefill_tokens} of {s.prompt_tokens} (reduction "
              f"{s.prefill_token_reduction:.4f}), {s.cow_copies} COW, "
              f"{s.dedup_hits} dedup, {s.cache_evictions} evictions; "
              f"TTFT p50 {r['ttft_p50_ms']:.1f} ms, "
              f"{r['tokens_per_s']:.1f} tok/s")
    again = runs["prefix_cache=True, run 2"]
    require(again["cache_hits"] == again["requests"],
            f"prefix: the second run hit {again['cache_hits']} of "
            f"{again['requests']} admissions on the persisted cache")
    eng.prefix_cache.check_invariants()
    del eng
    torch.cuda.empty_cache()
    print(f"[serve-x] prefix_cache=False: {off['dedup_hits']} dedup, "
          f"{off['cow_copies']} COW, prefill tokens {off['prefill_tokens']} "
          f"of {off['prompt_tokens']}; TTFT p50 {off['ttft_p50_ms']:.1f} ms, "
          f"{off['tokens_per_s']:.1f} tok/s; identical tokens cached and "
          f"not")
    return dict(uncached=off, **runs)


def phrase_requests(cfg, seed: int):
    """8 prompts, each a 16-token phrase repeated 4-8 times."""
    rng = np.random.default_rng(seed + 3)
    return [Request(uid=i, prompt=np.tile(
        rng.integers(2, cfg.vocab, 16), int(rng.integers(4, 9))).astype(
            np.int32), max_new_tokens=32) for i in range(8)]


def speculative_runs(cfg, qparams, seed: int, k: int = 4):
    """Plain greedy against speculative_k=k, graphed and graphed +
    pipelined (each engine warmed by one run first): identical tokens."""
    out = {}
    for label, kw in (("greedy graphed", dict()),
                      (f"speculative k={k} graphed",
                       dict(speculative_k=k)),
                      (f"speculative k={k} graphed+pipelined",
                       dict(speculative_k=k, pipelined=True))):
        eng = serve_engine(cfg, qparams, cuda_graphs=True, **kw)
        counted_run(eng, phrase_requests(cfg, seed), cfg,
                    f"{label}, warm-up (captures)")
        r = counted_run(eng, phrase_requests(cfg, seed), cfg, label)
        s = eng.stats
        for fn in (eng.step_set.step, eng.step_set.solo_step):
            require(fn.captures <= len(fn.widths), f"{label}: {fn.name} "
                    f"captured {fn.captures} greedy graphs past its "
                    f"{len(fn.widths)} widths")
        r.update(spec_rounds=s.spec_rounds, draft=s.spec_draft_tokens,
                 accepted=s.spec_accepted_tokens,
                 acceptance=s.spec_acceptance_rate,
                 pipelined_rounds=s.pipelined_rounds)
        if kw:
            require(r["tokens"] == out["greedy graphed"]["tokens"],
                    f"{label}: tokens differ from plain greedy's")
            require(s.spec_rounds > 0 and s.spec_draft_tokens > 0,
                    f"{label}: {s.spec_rounds} verify rounds, "
                    f"{s.spec_draft_tokens} draft tokens")
            print(f"[serve-x] {label}: {s.spec_rounds} verify rounds, "
                  f"{s.spec_accepted_tokens}/{s.spec_draft_tokens} drafts "
                  f"accepted (rate {s.spec_acceptance_rate:.4f}), "
                  f"{r['tokens_per_s']:.1f} tok/s against "
                  f"{out['greedy graphed']['tokens_per_s']:.1f} plain")
        out[label] = r
        del eng
        torch.cuda.empty_cache()
    return out


def head_times(cfg, seed: int):
    """The sampling head alone at the step's widths C = 1 and 256 (B = 4,
    the full vocab), two lanes sampled and two greedy, with and without
    the sampled branch: captured in a CUDA graph as the step set runs it
    (the graph's replay timed), and eagerly (the host enqueues each of
    its kernels, so the eager time is mostly the host's)."""
    timer = Timer(runs=10, warmup=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 4)
    table = samplib.lane_inputs(4)
    for lane in (0, 2):
        samplib.set_lane(table, lane, SamplingParams(seed=lane, **HOT),
                         lane)
    samp = {k: torch.from_numpy(v.view(np.int32) if k == "key" else v
                                ).cuda() for k, v in table.items()}
    out = {}
    for c in (1, 256):
        logits = torch.randn((4, c, cfg.vocab), generator=gen,
                             device="cuda") * 3
        pos = (torch.arange(c, dtype=torch.int32, device="cuda")[None]
               + torch.tensor([[5], [60], [0], [200]], dtype=torch.int32,
                              device="cuda"))
        n_new = torch.full((4,), c, dtype=torch.int32, device="cuda")

        def head(sampled):
            return samplib.select_tokens(
                logits, samp["temp"], samp["top_k"], samp["top_p"],
                samp["key"], pos, n_new, sampled=sampled)
        row = {}
        for sampled in (True, False):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                eager_tok, _ = head(sampled)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                graph_tok, _ = head(sampled)
            graph.replay()
            torch.cuda.synchronize()
            require(torch.equal(graph_tok, eager_tok), f"sampling head "
                    f"C={c}: the graph's tokens differ from eager ones")
            key = "sampled" if sampled else "greedy"
            row[f"{key}_graph_ms"] = timer(graph.replay)
            row[f"{key}_eager_ms"] = timer(lambda: head(sampled))
            del graph, graph_tok, eager_tok
        out[f"C={c}"] = row
        print(f"[serve-x] sampling head B=4 C={c} V={cfg.vocab}: with the "
              f"sampled branch {row['sampled_graph_ms']:.4f} ms graphed "
              f"({row['sampled_eager_ms']:.4f} eager), greedy-only "
              f"{row['greedy_graph_ms']:.4f} ms graphed "
              f"({row['greedy_eager_ms']:.4f} eager)")
        if c == 1:
            # the card's draw against the CPU's on the same inputs: the
            # threefry bits bit-exact (required); the tokens reported
            keys = samp["key"][[0, 2]]
            bits = samplib.random_bits(keys, cfg.vocab)
            require(torch.equal(bits.cpu(), samplib.random_bits(
                keys.cpu(), cfg.vocab)), "threefry bits on the card differ "
                "from the CPU's")
            tok, _ = head(True)
            want, _ = samplib.select_tokens(
                logits.cpu(), *(t.cpu() for t in (
                    samp["temp"], samp["top_k"], samp["top_p"], samp["key"],
                    pos, n_new)))
            row["tokens_equal_cpu"] = bool(torch.equal(tok.cpu(), want))
            print(f"[serve-x] threefry bits of a {cfg.vocab}-token draw: "
                  f"the card's equal the CPU's; head tokens equal the "
                  f"CPU's: {row['tokens_equal_cpu']}")
        del logits
    del timer
    torch.cuda.empty_cache()
    return out


def serve_x_phase(cfg, qparams, seed: int, greedy_tokens, pool_b: int):
    """Sampled lanes, the prefix cache with dedup and COW, speculative
    decode, and the head's own time, at the serve phase's width."""
    out = dict(sampled=sampled_lanes(cfg, qparams, seed, greedy_tokens,
                                     pool_b),
               prefix=prefix_cache_runs(cfg, qparams, seed),
               speculative=speculative_runs(cfg, qparams, seed),
               head=head_times(cfg, seed))
    print("[serve-x] every run launched "
          f"{', '.join(SERVE_KERNELS)} and never the qmm 'ref' path")
    return out


def whole_step(cfg, qparams, seed: int, tag: str = "step"):
    """Full-width steps from one arena, each run twice: through the
    kernels and through the plain versions. A mixed ragged step (decode,
    40-token chunk, decode, idle lane; M = 256, the column-strip qmm) and
    then a decode step (M = 4, the decode-width qmm)."""
    slots, page, mpps = 4, 16, 16
    pool = PagedKVPool(cfg, n_pages=slots * mpps, page=page,
                       max_slots=slots, max_pages_per_seq=mpps,
                       device="cuda")
    arena = pool.init_arena()
    rng = np.random.default_rng(seed)
    first = np.array([100, 60, 37, 0])     # prompt tokens in the arena
    steps = [("mixed ragged step", 64, np.array([1, 40, 1, 0])),
             ("decode step", 1, np.array([1, 1, 1, 0]))]
    total = first + sum(n for _, _, n in steps)
    for s in range(slots):
        if total[s]:
            pool.ensure(s, int(total[s]))
    serve_steps.apply_page_ops(arena, pool.device_tables())

    def run(tokens_np, start_np, n_np, use_kernels, arena):
        c = tokens_np.shape[1]
        start = torch.as_tensor(start_np, device="cuda")
        n_new = torch.as_tensor(n_np, device="cuda")
        pos = start[:, None] + torch.arange(c, device="cuda")[None, :]
        return forward(cfg, qparams, torch.as_tensor(tokens_np,
                                                     device="cuda"),
                       positions=pos, cache=arena, valid_len=start + n_new,
                       use_kernels=use_kernels, paged_attention=True)

    toks0 = rng.integers(2, cfg.vocab, size=(slots, 128)).astype(np.int64)
    run(toks0, np.zeros(slots, np.int64), first, True, arena)
    arena_plain = {k: {part: {n: t.clone() for n, t in leaves.items()}
                       for part, leaves in v.items()}
                   for k, v in arena.items()}
    out = {}
    start = first
    for label, c, n_new in steps:
        toks = rng.integers(2, cfg.vocab, size=(slots, c)).astype(np.int64)
        lk = run(toks, start, n_new, True, arena)
        lp = run(toks, start, n_new, False, arena_plain)
        torch.cuda.synchronize()
        live = torch.arange(c, device="cuda")[None, :] < torch.as_tensor(
            n_new, device="cuda")[:, None]
        diff = (lk[live] - lp[live]).abs().max().item()
        scale = lp[live].abs().max().item()
        require(diff <= 1e-3 * scale, f"{label}: logits differ by "
                f"{diff:.3e} > 1e-3 * max|logits| = {1e-3 * scale:.3e}")
        print(f"[{tag}] {label} (C={c}, n_new={n_new.tolist()}): "
              f"max|logits diff| {diff:.3e} vs 1e-3 * max|logits| "
              f"{1e-3 * scale:.3e}")
        out[label] = dict(max_abs_diff=diff, max_abs_logit=scale)
        start = start + n_new
    return out


# ---------------------------------------------------------------------------
# phase 4o: observability of the serving path
# ---------------------------------------------------------------------------
def check_spans(events, label: str) -> None:
    """Round phase spans do not overlap, and those that imply a completed
    round (host prep, device step, dispatch, emit) sit inside a
    ``round`` span; a pipelined retire lands in the next round's window
    or in a drain, as in the JAX engine."""
    phases = sorted((e for e in events if e["ph"] == "X"
                     and e["name"].startswith("round/")),
                    key=lambda e: e["ts"])
    rounds = [e for e in events if e["ph"] == "X" and e["name"] == "round"]
    require(phases and rounds, f"{label}: no phase or round spans")
    for a, b in zip(phases, phases[1:]):
        require(a["ts"] + a["dur"] <= b["ts"] + 1.0,
                f"{label}: {a['name']} overlaps {b['name']}")
    for e in phases:
        if e["name"] in ("round/host_prep", "round/device_step",
                         "round/dispatch", "round/emit"):
            require(any(r["ts"] - 1.0 <= e["ts"] and e["ts"] + e["dur"]
                        <= r["ts"] + r["dur"] + 1.0 for r in rounds),
                    f"{label}: {e['name']} outside any round")


def phase_breakdown(events, stats, label: str) -> dict:
    """Per-phase ms at p50 over the rounds that ran it, and the run's
    host and device seconds against its wall."""
    durs = {}
    for e in events:
        if e["ph"] == "X" and e["name"].startswith("round"):
            durs.setdefault(e["name"], []).append(e["dur"] / 1e3)
    p50 = {k: float(np.median(v)) for k, v in durs.items()}
    host, dev = stats.host_seconds(), stats.device_seconds()
    print(f"[obs] {label}: phase ms p50 " + ", ".join(
        f"{k.split('/')[-1]} {v:.3f} (x{len(durs[k])})"
        for k, v in sorted(p50.items())))
    print(f"[obs] {label}: host {host * 1e3:.2f} ms + device "
          f"{dev * 1e3:.2f} ms of {stats.wall_s * 1e3:.2f} ms wall over "
          f"{stats.rounds} rounds (host share {host / stats.wall_s:.4f}, "
          f"device share {dev / stats.wall_s:.4f})")
    return dict(phase_ms_p50=p50, phase_counts={k: len(v) for k, v in
                                               durs.items()},
                host_s=host, device_s=dev, wall_s=stats.wall_s,
                rounds=stats.rounds, tokens_per_s=stats.tokens_per_s)


def launch_split(eng, runs: int = 20) -> dict:
    """What ``round/device_step`` holds besides the device's work and the
    readback wait: the host ms of one C = 1 step call (staging upload and
    graph launch) and of the greedy graph's ``replay()`` call alone, each
    made with the device idle, and the replay's device ms (CUDA events);
    medians over ``runs``. Every lane idle (their writes land on the null
    page)."""
    sset = eng.step_set
    z = np.zeros(sset.max_slots, np.int32)
    args = (eng._exec_params, np.zeros((sset.max_slots, 1), np.int32),
            eng._arena, z, z, samplib.lane_inputs(sset.max_slots))
    sset.step(*args)
    graph = sset.step._widths[1].graphs[False].graph
    call, replay, dev = [], [], []
    for _ in range(runs):
        for fn, times in ((lambda: sset.step(*args), call),
                          (graph.replay, replay)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b))
    out = dict(step_call_host_ms=float(np.median(call)),
               replay_call_host_ms=float(np.median(replay)),
               replay_device_ms=float(np.median(dev)))
    print(f"[obs] C=1 step with the device idle: step call host "
          f"{out['step_call_host_ms']:.3f} ms, graph replay() call host "
          f"{out['replay_call_host_ms']:.3f} ms, replay device "
          f"{out['replay_device_ms']:.3f} ms (medians of {runs})")
    return out


def traced_run(cfg, qparams, seed: int, ref_tokens, label: str,
               split: bool = False, **kw):
    """(i)/(ii): the graphed engine with an enabled tracer and a registry
    of its own, warmed by a first run (captures), then measured with the
    launch counts set to 0 just before: tokens equal the untraced run's,
    spans well formed, one ``req/first_token`` per request, the registry's
    rounds equal to the run's, every serving kernel launched."""
    trc, reg = obs_trace.Tracer(), obs_metrics.Registry()
    eng = serve_engine(cfg, qparams, cuda_graphs=True, tracer=trc,
                       metrics=reg, **kw)
    eng.run(make_requests(cfg, 8, seed))
    torch.cuda.synchronize()
    trc.clear()
    reg.reset()
    reqs = make_requests(cfg, 8, seed)
    build.reset_launches()
    kops.reset_path_counts()
    eng.run(reqs)
    torch.cuda.synchronize()
    launches = dict(build.launches)
    s = eng.stats
    require([r.out_tokens for r in reqs] == ref_tokens,
            f"{label}: traced tokens differ from the untraced run's")
    for k in SERVE_KERNELS:
        require(launches[k] > 0, f"{label}: kernel {k} never launched")
    require(kops.path_counts["ref"] == 0, f"{label}: qmm took 'ref'")
    check_spans(trc.events, label)
    firsts = sorted(e["args"]["uid"] for e in trc.events
                    if e["name"] == "req/first_token")
    require(firsts == sorted(r.uid for r in reqs),
            f"{label}: req/first_token per request {firsts}")
    require(reg.counter("serve_rounds_total").value() == s.rounds,
            f"{label}: serve_rounds_total differs from the run's rounds")
    out = phase_breakdown(trc.events, s, label)
    out.update(events=len(trc.events), launches=launches,
               pipelined_rounds=s.pipelined_rounds)
    if split:
        out["launch"] = launch_split(eng)
    return out


def cost_run(cfg, qparams, seed: int, ref_tokens):
    """(iii): cost capture on, the process tracer on: one attributed
    step/solo_step dispatch per round, a drift for every width, identical
    tokens; then one step under the sync debugger with both on."""
    prev_c = obs_costs.enable_capture(True)
    trc = obs_trace.Tracer()
    prev_t = obs_trace.set_tracer(trc)
    try:
        eng = serve_engine(cfg, qparams, cuda_graphs=True,
                           metrics=obs_metrics.Registry())
        eng.run(make_requests(cfg, 8, seed))
        torch.cuda.synchronize()
        reqs = make_requests(cfg, 8, seed)
        eng.run(reqs)
        torch.cuda.synchronize()
        s = eng.stats
        require([r.out_tokens for r in reqs] == ref_tokens,
                "cost: tokens differ from the untraced run's")
        rep = eng.last_cost_report
        rows = [r for r in rep.fns if r.fn in ("step", "solo_step")]
        require(sum(r.calls for r in rows) == s.rounds,
                f"cost: {sum(r.calls for r in rows)} attributed step "
                f"dispatches for {s.rounds} rounds")
        require(all(r.captured and r.drift > 0 for r in rows),
                "cost: a step width without a count or a drift")
        table = []
        for r in sorted(rows, key=lambda r: (r.fn, int(r.key[1:]))):
            t = r.roofline()
            row = dict(fn=r.label, calls=r.calls,
                       wall_ms_per_call=r.wall_s / r.calls * 1e3,
                       flops=r.flops_per_call, bytes=r.bytes_per_call,
                       roofline_ms=t.roofline_time * 1e3,
                       bound_by=t.bottleneck, drift=r.drift)
            table.append(row)
            print(f"[obs] cost {r.label:14s} calls {r.calls:3d} wall "
                  f"{row['wall_ms_per_call']:8.3f} ms/call, "
                  f"{r.flops_per_call:.4e} FLOPs, {r.bytes_per_call:.4e} "
                  f"bytes, roofline {row['roofline_ms']:.4f} ms "
                  f"({t.bottleneck}), drift {r.drift:.2f}")
        n_cost = sum(e["name"].startswith("cost/") for e in trc.events)
        print(f"[obs] cost: {s.rounds} rounds, one attributed dispatch "
              f"each; {n_cost} cost/<fn> samples on the process tracer; "
              f"modeled "
              f"{rep.modeled['bytes_per_token'] / 1e6:.3f} MB/token "
              f"({rep.modeled['method']})")
        check_no_host_sync(eng)
        print("[obs] cost: the sync check above ran with the process "
              "tracer and cost capture on")
        out = dict(rows=table, rounds=s.rounds, wall_s=s.wall_s,
                   tokens_per_s=s.tokens_per_s, modeled=rep.modeled)
    finally:
        obs_costs.enable_capture(prev_c)
        obs_trace.set_tracer(prev_t)
    del eng
    torch.cuda.empty_cache()
    return out


def tracing_overhead(cfg, qparams, seed: int, pairs: int = 3):
    """(iv): graphed runs with tracing off and on, alternated in pairs
    (off-on, on-off, ...), both engines warm; tok/s of each and the
    median on/off ratio (no gate: runs of one tree spread)."""
    trc = obs_trace.Tracer()
    engines = {"off": serve_engine(cfg, qparams, cuda_graphs=True,
                                   metrics=obs_metrics.Registry()),
               "on": serve_engine(cfg, qparams, cuda_graphs=True,
                                  tracer=trc,
                                  metrics=obs_metrics.Registry())}
    for eng in engines.values():
        eng.run(make_requests(cfg, 8, seed))
    torch.cuda.synchronize()
    tps = {"off": [], "on": []}
    for i in range(pairs):
        for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
            trc.clear()
            engines[mode].run(make_requests(cfg, 8, seed))
            torch.cuda.synchronize()
            tps[mode].append(engines[mode].stats.tokens_per_s)
    ratios = [b / a for a, b in zip(tps["off"], tps["on"])]
    print(f"[obs] tracing off tok/s {[round(x, 1) for x in tps['off']]}, "
          f"on {[round(x, 1) for x in tps['on']]}; on/off per pair "
          f"{[round(x, 4) for x in ratios]}, median "
          f"{float(np.median(ratios)):.4f}")
    del engines
    torch.cuda.empty_cache()
    return dict(off=tps["off"], on=tps["on"], ratios=ratios,
                median_ratio=float(np.median(ratios)))


def cli_run():
    """(v): the CLI at full width with the four observability flags, into
    ``build/obs`` (git-ignored), with a registry of its own."""
    from repro_torch.launch import serve as serve_cli
    out = ROOT / "build" / "obs"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    files = {"trace": out / "trace.json", "metrics": out / "metrics.json",
             "profile": out / "profile"}
    prev = obs_metrics.set_registry(obs_metrics.Registry())
    try:
        eng = serve_cli.main([
            "--no-reduced", "--weights", "qmc", "--paged-attention",
            "--trace-out", str(files["trace"]),
            "--metrics-out", str(files["metrics"]), "--cost-report",
            "--profile", str(files["profile"])])
    finally:
        obs_metrics.set_registry(prev)
    trace = json.loads(files["trace"].read_text())["traceEvents"]
    metrics = json.loads(files["metrics"].read_text())
    prof = sorted(files["profile"].glob("*.json"))
    require(prof and any(e["name"] == "round" for e in trace)
            and metrics["serve_rounds_total"]["series"][0]["value"]
            == eng.stats.rounds and eng.last_cost_report is not None,
            "cli: a file is missing or does not match the run")
    sizes = {str(p.relative_to(ROOT)): p.stat().st_size
             for p in [files["trace"], files["metrics"], *prof]}
    print(f"[obs] cli --no-reduced --weights qmc --paged-attention "
          f"--trace-out --metrics-out --cost-report --profile: "
          f"{eng.stats.rounds} rounds, {len(trace)} trace events; bytes "
          + ", ".join(f"{k} {v}" for k, v in sizes.items()))
    del eng
    torch.cuda.empty_cache()
    return dict(sizes=sizes, trace_events=len(trace))


def obs_phase(cfg, qparams, seed: int, ref_tokens, idle):
    """(i) traced graphed, (ii) traced graphed+pipelined, (iii) cost
    capture, (iv) tracing off/on pairs, (v) the CLI; the host share of
    (i) beside the [idle] phase's profiler idle share of (b)."""
    out = dict(graphed=traced_run(cfg, qparams, seed, ref_tokens,
                                  "(i) graphed", split=True),
               pipelined=traced_run(cfg, qparams, seed, ref_tokens,
                                    "(ii) graphed+pipelined",
                                    pipelined=True))
    torch.cuda.empty_cache()
    out["cost"] = cost_run(cfg, qparams, seed, ref_tokens)
    out["overhead"] = tracing_overhead(cfg, qparams, seed)
    out["cli"] = cli_run()
    g, b = out["graphed"], idle["b graphed"]
    print(f"[obs] (i) host share {g['host_s'] / g['wall_s']:.4f} of the "
          f"8-request run; [idle] (b) decode window: profiler idle share "
          f"{b['idle_share']:.4f}, without the profiler "
          f"{b['plain_idle_share']:.4f}")
    return out


# ---------------------------------------------------------------------------
# phase 4h: hybrid and SSM stacks at full width
# ---------------------------------------------------------------------------
def ssm_model(arch: str, seed: int):
    """A hybrid or SSM arch at its published width: random weights from
    the seed, QMC PTQ with rho 0.3 on the card."""
    cfg = get_config(arch)
    t0 = time.monotonic()
    params = init_params(cfg, seed, device="cuda")
    qparams = quantize_for_serving(params, QMCConfig(
        rho=0.3, granularity="subtile"), min_dim=64)
    del params
    torch.cuda.synchronize()
    print(f"[hybrid] {arch} full width ({cfg.n_layers} layers, pattern "
          f"{cfg.pattern}, d {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, d_state "
          f"{cfg.d_state}, window {cfg.window}): init + QMC PTQ on the card "
          f"in {time.monotonic() - t0:.1f}s")
    return cfg, qparams


def qmm_plan_calls(qparams):
    """Per step call, the QTensor matmuls ``kernels.ops.qmm_plan`` sends to
    the plain "ref" path (K or N not a multiple of 128) and to a kernel,
    with the shapes of each kind."""
    calls = {"ref": 0, "kernel": 0}
    shapes = {"ref": set(), "kernel": set()}
    for qt in qtensors(qparams):
        k, n = qt.shape
        kind = ("ref" if kops.qmm_plan(8, k, n, qt.subtile)["path"] == "ref"
                else "kernel")
        calls[kind] += 1
        shapes[kind].add(f"{k}x{n}")
    return calls, {k: sorted(v) for k, v in shapes.items()}


def graph_ms(fn, runs: int = 20) -> float:
    """Device ms of ``fn`` captured into one CUDA graph (warm on a side
    stream first), the median of ``runs`` timed replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del graph
    return float(np.median(times))


def decode_round_parts(cfg, qparams, lanes: int = 4) -> dict:
    """A C = 1 round's work at ``lanes`` lanes, by part, each part the
    calls of one round captured into a CUDA graph and timed: the QTensor
    leaves on qmm's "ref" path (dequantize, then one matmul), the dense
    projections and the head, the Mamba2 mixers whole (state rows of
    spare tensors) and their two projections alone."""
    from repro_torch.models.model import group_slice
    from repro_torch.models.ssm import mamba_block
    dev = qparams["embed"]["tok"].device
    xs = {}

    def x(k):
        if k not in xs:
            xs[k] = torch.randn((lanes, k), device=dev)
        return xs[k]

    qts, dense = [], []
    for blk in qparams["blocks"].values():
        for part in ("attn", "mamba", "ffn"):
            for name, leaf in blk.get(part, {}).items():
                if name in ("in_proj", "out_proj", "wq", "wk", "wv", "wo",
                            "w_up", "w_gate", "w_down"):
                    for g in range(cfg.n_groups):
                        (qts if isinstance(leaf, list) else dense).append(
                            leaf[g])
    head = (qparams["embed"]["tok"].T if cfg.tie_embeddings
            else qparams["lm_head"])
    (qts if isinstance(head, QTensor) else dense).append(head)
    ref = [q for q in qts
           if kops.qmm_plan(lanes, *q.shape, q.subtile)["path"] == "ref"]
    out = dict(ref_calls=len(ref), dense_calls=len(dense))
    out["ref_ms"] = graph_ms(lambda: [kops.qmm(x(q.shape[0]), q)
                                      for q in ref]) if ref else 0.0
    out["dense_ms"] = graph_ms(lambda: [torch.matmul(x(w.shape[0]), w)
                                        for w in dense])
    mixers = [(group_slice(blk["mamba"], g))
              for blk in qparams["blocks"].values() if "mamba" in blk
              for g in range(cfg.n_groups)]
    if mixers:
        h = torch.randn((lanes, 1, cfg.d_model), device=dev)
        cache = {"ssm": torch.zeros((lanes, cfg.ssm_nheads,
                                     cfg.ssm_headdim, cfg.d_state),
                                    device=dev),
                 "conv": torch.zeros((lanes, cfg.d_conv - 1, cfg.conv_dim),
                                     device=dev)}
        valid = torch.ones(lanes, dtype=torch.int32, device=dev)
        out["mixer_calls"] = len(mixers)
        out["mixer_ms"] = graph_ms(lambda: [
            mamba_block(p, h, cfg, cache=cache, valid_len=valid)
            for p in mixers])
        out["mixer_proj_ms"] = graph_ms(lambda: [
            (torch.matmul(x(cfg.d_model), p["in_proj"]),
             kops.qmm(x(cfg.d_inner), p["out_proj"])
             if isinstance(p["out_proj"], QTensor)
             else torch.matmul(x(cfg.d_inner), p["out_proj"]))
            for p in mixers])
    return out


def hybrid_arch(arch: str, seed: int, runs, kernels, breakdown: bool,
                kept: dict):
    """One hybrid or SSM arch at full width through the serve runs
    ``runs`` (identical tokens), the sync-debugger step, the profiler over
    a decode window of (b), the decode round by part, and one whole step
    through the kernels against the plain versions. Its streams stay in
    ``kept[arch]`` as ``(cfg, qparams, "ref" calls a step)`` for
    ``[mesh-x]``."""
    cfg, qparams = ssm_model(arch, seed)
    calls, shapes = qmm_plan_calls(qparams)
    n_g = cfg.n_groups
    print(f"[hybrid] {arch}: QTensor matmuls a step call: {calls['ref']} on "
          f"qmm's 'ref' path (K or N not a multiple of 128: "
          f"{shapes['ref']}), {calls['kernel']} on a kernel "
          f"({shapes['kernel']}); {n_g} groups")
    out, toks = {}, {}
    for label, kw in runs:
        out[label], toks[label], eng = serve(
            cfg, qparams, seed, f"{arch} {label}", kernels=kernels,
            ref_per_call=calls["ref"], tag="hybrid", **kw)
        if label.startswith("a"):
            check_no_host_sync(eng, tag="hybrid")
        if label.startswith("b"):
            out["idle"] = idle_share(eng, cfg, seed, f"{arch} {label}",
                                     top=12, tag="hybrid")
        del eng
        torch.cuda.empty_cache()
    ref = toks[runs[0][0]]
    for label, _ in runs[1:]:
        require(toks[label] == ref, f"hybrid {arch}: {label} tokens differ "
                f"from the eager run's")
    print(f"[hybrid] {arch}: identical tokens in the "
          + ", ".join(label for label, _ in runs) + " runs")
    if breakdown:
        parts = decode_round_parts(cfg, qparams)
        busy = out["idle"]["busy_ms"] / out["idle"]["rounds"]
        print(f"[hybrid] {arch} decode round by part (4 lanes, C = 1, each "
              f"part one CUDA graph; ms): qmm 'ref' {parts['ref_calls']} "
              f"calls {parts['ref_ms']:.3f}; dense fp32 projections and "
              f"head {parts['dense_calls']} matmuls "
              f"{parts['dense_ms']:.3f}; Mamba2 mixers "
              f"{parts.get('mixer_calls', 0)} whole "
              f"{parts.get('mixer_ms', 0.0):.3f}, their in/out "
              f"projections {parts.get('mixer_proj_ms', 0.0):.3f}; "
              f"profiler busy per round of (b)'s window {busy:.3f}")
        out["parts"] = parts
    out["step"] = whole_step(cfg, qparams, seed, tag="hybrid")
    kept[arch] = (cfg, qparams, calls["ref"])
    return out


def hybrid_phase(seed: int, kept: dict) -> dict:
    """hymba-1.5b (a, b, c) and mamba2-370m (a, b) at full width; their
    streams stay in ``kept``."""
    return {"hymba-1.5b": hybrid_arch(
                "hymba-1.5b", seed, SERVE_RUNS,
                ("ragged_paged_attention",), breakdown=True, kept=kept),
            "mamba2-370m": hybrid_arch(
                "mamba2-370m", seed, SERVE_RUNS[:2],
                ("qmm_decode", "qmm_colstrip"), breakdown=True,
                kept=kept)}


# ---------------------------------------------------------------------------
# phase 4m: a mixture-of-experts stack at full width
# ---------------------------------------------------------------------------
MOE_LAYERS = 2          # of dbrx-132b's 40: its codes alone fill ~7 GB
EXPERT_SHAPES = [(6144, 10752), (10752, 6144)]


def check_expert_qmm(timer, peak, gen, rows):
    """The decode-width qmm at dbrx-132b's expert shapes (w_up / w_gate
    6144 x 10752, w_down 10752 x 6144) and the rows a 4-lane decode round
    gives each expert: capacity 4, padded to 8."""
    for k, n in EXPERT_SHAPES:
        qt = quantize_qtensor(make_weight(k, n, gen), QMCConfig(
            rho=0.3, granularity="subtile"))
        w_dense = dequantize_qtensor(qt, torch.float32)
        x = torch.zeros((8, k), device="cuda")
        x[:4] = torch.randn((4, k), generator=gen, device="cuda")
        rows.append(qmm_row(timer, "qmm_decode", qmm_decode, x, qt, w_dense,
                            4, f"M=4 K={k} N={n} dbrx expert", peak))
        del qt, w_dense


def moe_model(seed: int):
    """dbrx-132b at its published widths, depth cut to ``MOE_LAYERS``:
    random weights from the seed, QMC PTQ with rho 0.3 on the card, the
    fp32 tree freed after it."""
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=MOE_LAYERS)
    t0 = time.monotonic()
    params = init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    fp32_gb = torch.cuda.memory_allocated() / 1e9
    qparams = quantize_for_serving(params, QMCConfig(
        rho=0.3, granularity="subtile"), min_dim=64)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    codes = sum(qt.nbytes_container() for qt in qtensors(qparams))
    print(f"[moe] dbrx-132b full width (d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, "
          f"{cfg.n_experts} experts top-{cfg.topk}, vocab {cfg.vocab}, rope "
          f"theta {cfg.rope_theta:g}, capacity factor "
          f"{cfg.capacity_factor}); depth cut to {MOE_LAYERS} of 40 layers; "
          f"init + QMC PTQ on the card in {time.monotonic() - t0:.1f}s; "
          f"{fp32_gb:.1f} GB allocated with the fp32 tree, QTensor codes "
          f"and metadata {codes / 1e9:.2f} GB")
    return cfg, qparams


def moe_round_parts(cfg, qparams, arena, lanes: int = 4) -> dict:
    """A C = 1 round's MoE FFNs at ``lanes`` lanes (router, dispatch, the
    experts' products, combine) as one CUDA graph, the experts' products
    alone as another, and the step's counted bytes over the card's memory
    rate (the round's floor)."""
    from repro_torch.models.model import group_slice
    from repro_torch.models.moe import capacity, moe_block
    dev = qparams["embed"]["tok"].device
    h = torch.randn((lanes, 1, cfg.d_model), device=dev)
    ffns = [group_slice(blk["ffn"], g) for blk in qparams["blocks"].values()
            for g in range(cfg.n_groups)]
    cap = capacity(lanes, cfg)
    bufs = {}

    def x(k):
        if k not in bufs:
            bufs[k] = torch.randn((cap, k), device=dev)
        return bufs[k]
    products = [w for p in ffns for name in ("w_gate", "w_up", "w_down")
                for w in p[name]]
    out = dict(layers=len(ffns), cap=cap, products=len(products),
               pad_m=kops.qmm_plan(cap, cfg.d_model, cfg.d_ff,
                                   (8, 128))["pad_m"])
    out["moe_ms"] = graph_ms(lambda: [moe_block(p, h, cfg) for p in ffns])
    out["experts_ms"] = graph_ms(lambda: [kops.qmm(x(w.shape[0]), w)
                                          for w in products])
    work = obs_costs.step_work(cfg, qparams, arena, lanes=lanes, c=1)
    out["step_bytes"] = work["bytes"]
    out["floor_ms"] = work["bytes"] / rl.HBM_BW * 1e3
    return out


def moe_phase(seed: int, kernel_rows, kept: dict) -> dict:
    """dbrx-132b (2 layers) through the serve runs (a), (b), (c): tokens
    identical, qmm_decode and attention launched in every run (on replay
    too), qmm's "ref" path never; one eager step under the sync debugger;
    the decode window's busy time and the round's MoE part; one whole
    step through the kernels against the plain versions. Its streams stay
    in ``kept["dbrx-132b"]`` for ``[mesh-x]``."""
    cfg, qparams = moe_model(seed)
    out, toks = {}, {}
    kernels = ("qmm_decode", "ragged_paged_attention")
    for label, kw in SERVE_RUNS:
        out[label], toks[label], eng = serve(
            cfg, qparams, seed, f"dbrx-132b {label}", kernels=kernels,
            tag="moe", **kw)
        if label.startswith("a"):
            check_no_host_sync(eng, tag="moe")
        if label.startswith("b"):
            out["idle"] = idle_share(eng, cfg, seed, f"dbrx-132b {label}",
                                     top=8, tag="moe")
            parts = moe_round_parts(cfg, qparams, eng._arena)
            busy = out["idle"]["busy_ms"] / out["idle"]["rounds"]
            print(f"[moe] decode round (4 lanes, C = 1; ms): profiler busy "
                  f"per round of (b)'s window {busy:.3f}; the "
                  f"{parts['layers']} MoE FFNs whole (router, dispatch, "
                  f"{parts['products']} expert products at capacity "
                  f"{parts['cap']} padded to {parts['pad_m']}, combine) as one CUDA graph "
                  f"{parts['moe_ms']:.3f}, the expert products alone "
                  f"{parts['experts_ms']:.3f}; the step's counted bytes "
                  f"{parts['step_bytes'] / 1e9:.3f} GB, floor "
                  f"{parts['floor_ms']:.3f} at {rl.HBM_BW / 1e12:.2f} TB/s")
            out["parts"] = dict(parts, busy_ms_per_round=busy)
        del eng
        torch.cuda.empty_cache()
    ref = toks[SERVE_RUNS[0][0]]
    for label, _ in SERVE_RUNS[1:]:
        require(toks[label] == ref, f"moe: {label} tokens differ from the "
                f"eager run's")
    print("[moe] identical tokens in the eager, graphed and "
          "graphed+pipelined runs")
    out["step"] = whole_step(cfg, qparams, seed, tag="moe")
    out["expert_rows"] = [r for r in kernel_rows
                          if r["shape"].endswith("dbrx expert")]
    kept["dbrx-132b"] = (cfg, qparams, qmm_plan_calls(qparams)[0]["ref"])
    return out


# ---------------------------------------------------------------------------
# phase 4e: MoE, SSM and hybrid stacks on the serving mesh
# ---------------------------------------------------------------------------
# (mesh shape, the archs its ranks serve in order); each arch's streams
# are the [hybrid] and [moe] phases' own
FAMILY_MESH = (((2, 2), ("dbrx-132b", "mamba2-370m", "hymba-1.5b")),)
# the kernels each arch's ranks must launch (and every kernel its one
# process run launched); hymba's streams all take qmm's "ref" path
# the encoder-decoder and VLM stacks whose contiguous prefill and decode
# ride the same (2, 2) spawn ([mesh-contig]), on the [families] phase's
# streams
FAMILY_CONTIG = ("whisper-medium", "internvl2-2b")
FAMILY_KERNELS = {"dbrx-132b": ("qmm_decode", "ragged_paged_attention"),
                  "mamba2-370m": ("qmm_decode",),
                  "hymba-1.5b": ("ragged_paged_attention",)}


def expert_codes(tree) -> int:
    """Bytes of the QTensor experts a (rank's) parameter tree holds: every
    held entry of its ``[G][E]`` lists (``None`` is another rank's)."""
    if isinstance(tree, dict):
        return sum(expert_codes(v) for v in tree.values())
    if isinstance(tree, list) and tree and isinstance(tree[0], list):
        return sum(q.nbytes_container() for row in tree for q in row
                   if q is not None)
    return 0


def family_mesh_rank(mesh, job):
    """One gloo rank of ``[mesh-x]``: each arch of ``job["order"]`` in turn
    served through ``ServeEngine(mesh=...)`` on the parent's streams (CUDA
    IPC; the rank keeps its slice: its experts, its TP columns and rows,
    a replicated attention block whole), eagerly, once, with the launch
    counts set to 0 just before the run and the collectives counted by
    kind over it; the bytes of the expert codes the rank holds and its
    arena's fused KV width. Prints nothing."""
    t_rank = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    out = {"rank": mesh.rank, "coords": mesh.coords, "archs": {},
           "contig": {}}
    for arch in job["order"]:
        model = job["models"][arch]
        t0 = time.monotonic()
        eng = ServeEngine(model["cfg"], model["qparams"], slots=4,
                          max_len=256, paged_attention=True, device="cuda",
                          mesh=mesh, cuda_graphs=False)
        held = expert_codes(eng.params)
        reqs = model["requests"]
        setup_s = time.monotonic() - t0
        build.reset_launches()
        kops.reset_path_counts()
        k0 = {k: list(v) for k, v in mesh.by_kind.items()}
        eng.run(reqs)
        torch.cuda.synchronize()
        st = eng.stats
        kinds = {k: [v[i] - k0.get(k, [0, 0.0, 0])[i] for i in range(3)]
                 for k, v in mesh.by_kind.items()}
        out["archs"][arch] = dict(
            tokens=[r.out_tokens for r in reqs],
            launches=dict(build.launches), paths=dict(kops.path_counts),
            rounds=st.rounds, tokens_out=st.tokens_out, wall_s=st.wall_s,
            tokens_per_s=st.tokens_per_s,
            round_ms_p50=float(np.median(st.step_seconds) * 1e3),
            by_kind={k: v for k, v in kinds.items() if v[0]},
            expert_bytes=held, setup_s=setup_s,
            kv_width=next((g["attn"]["k_pages"].shape[-1]
                           for g in eng._arena.values() if "attn" in g), 0))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for arch, model in job["contig"].items():
        out["contig"][arch] = contig_rank(mesh, model)
        gc.collect()
        torch.cuda.empty_cache()
    # drop every reference to the parent's streams (CUDA IPC) before the
    # rank exits, so their counters fall to zero and the parent can free
    # them (torch.cuda.ipc_collect); a reference left at exit pins them in
    # the parent for its lifetime
    for model in (*job["models"].values(), *job["contig"].values()):
        model.clear()
    gc.collect()
    torch.cuda.synchronize()
    out["rank_s"] = time.monotonic() - t_rank
    return out


def contig_rank(mesh, model) -> dict:
    """One gloo rank of ``[mesh-contig]``: ``serve.steps.build_prefill``
    over the rank's row of the [families] batch (``sharding.batch_rows``)
    and ``FAMILY_STEPS`` greedy ``build_decode`` steps on the parent's
    streams (CUDA IPC), cut to the rank's slices (``shard_params``), with
    a fresh fp32 cache (``sharding.local_cache``); each call's logits made
    whole over the mesh (``gather_logits``, kind ``logits``) and held
    against the one process's ``family_run`` (kernels) on the rank; the
    launch counts set to 0 just before the run and read just after."""
    cfg, toks, extra = model["cfg"], model["toks"], model["extra"]
    b = toks.shape[0]
    rows = shd.batch_rows(mesh, b)
    n_vis = cfg.n_vis_tokens if "vis_embeds" in extra else 0
    max_len = n_vis + FAMILY_PROMPT + FAMILY_STEPS + 1
    t0 = time.monotonic()
    local = shd.shard_params(model["qparams"], mesh, cfg)
    prefill_fn = serve_steps.build_prefill(
        cfg, mesh, batch=b, seq=FAMILY_PROMPT, cache_len=max_len,
        cache_dtype=torch.float32)
    decode_fn = serve_steps.build_decode(cfg, mesh, batch=b,
                                         cache_len=max_len)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    build.reset_launches()
    kops.reset_path_counts()
    k0 = {k: list(v) for k, v in mesh.by_kind.items()}
    t0 = time.monotonic()
    with torch.no_grad():
        lg, cache = prefill_fn(local, toks[rows],
                               {k: v[rows] for k, v in extra.items()})
        logits, fed = [serve_steps.gather_logits(lg, mesh, b, cfg)], []
        for i in range(FAMILY_STEPS):
            nxt = torch.argmax(logits[-1], dim=-1)
            fed.append(nxt)
            lg, cache = decode_fn(local, nxt[rows].reshape(-1, 1), cache,
                                  n_vis + FAMILY_PROMPT + i)
            logits.append(serve_steps.gather_logits(lg, mesh, b, cfg))
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches, paths = dict(build.launches), dict(kops.path_counts)
    kinds = {k: [v[i] - k0.get(k, [0, 0.0, 0])[i] for i in range(3)]
             for k, v in mesh.by_kind.items()}
    lk = torch.stack(logits, dim=1)
    scale = model["logits"].abs().max().item()
    self_kv = cache["b0"]["self"] if cfg.is_encdec else cache["b0"]["attn"]
    out = dict(max_abs_diff=(lk - model["logits"]).abs().max().item(),
               scale=scale, finite=bool(torch.isfinite(lk).all()),
               tokens_equal=torch.equal(torch.stack(fed, dim=1),
                                        model["fed"]),
               launches=launches, paths=paths,
               by_kind={k: v for k, v in kinds.items() if v[0]},
               kv_width=self_kv["k"].shape[-1],
               rows=self_kv["k"].shape[1], setup_s=setup_s, run_s=run_s)
    del local, cache, lk, logits
    return out


def check_contig(res, contig: dict, shape) -> dict:
    """The [mesh-contig] checks on every rank's result, and its lines."""
    label = f"({shape[0]},{shape[1]})"
    out = {}
    for arch, model in contig.items():
        cfg = model["cfg"]
        want = cfg.kv_dim if attn_replicated(cfg, shape[1]) \
            else cfg.kv_dim // shape[1]
        for r in res:
            got = r["contig"][arch]
            tag = f"mesh-contig {arch} {label} rank {r['rank']}"
            require(got["finite"], f"{tag}: non-finite logits")
            require(got["max_abs_diff"] <= 1e-3 * got["scale"], f"{tag}: "
                    f"logits differ from one process's by "
                    f"{got['max_abs_diff']:.3e} > 1e-3 * max|logits| = "
                    f"{1e-3 * got['scale']:.3e}")
            require(got["tokens_equal"], f"{tag}: greedy tokens differ "
                    f"from one process's")
            require(got["launches"]["qmm_decode"] > 0, f"{tag}: the decode "
                    f"qmm never launched")
            require(got["kv_width"] == want, f"{tag}: its cache holds "
                    f"{got['kv_width']} KV columns, not {want}")
        r0 = res[0]["contig"][arch]
        kinds = {k: f"{v[0]} ({v[1] * 1e3:.1f} ms, {v[2] / 1e6:.3f} MB)"
                 for k, v in sorted(r0["by_kind"].items())}
        diffs = ", ".join(f"{r['contig'][arch]['max_abs_diff']:.3e}"
                          for r in res)
        print(f"[mesh-contig] {arch} {label} gloo, {len(res)} ranks on one "
              f"card: build_prefill over {FAMILY_PROMPT} tokens + "
              f"{FAMILY_STEPS} greedy build_decode steps, a rank's row of "
              f"the batch of 2; every rank's tokens equal one process's, "
              f"max|logits diff| by rank {diffs} (1e-3 * max|logits| "
              f"{1e-3 * r0['scale']:.3e}); rank 0: KV columns "
              f"{r0['kv_width']} of {cfg.kv_dim}, rows {r0['rows']}; "
              f"collectives by kind (calls, seconds, payload) {kinds}; "
              f"launches {r0['launches']}; qmm paths {r0['paths']}; run "
              f"{r0['run_s']:.2f}s, set-up {r0['setup_s']:.2f}s")
        out[arch] = dict(r0, ranks=len(res),
                         max_abs_diffs=[r["contig"][arch]["max_abs_diff"]
                                        for r in res])
    return out


def family_mesh_phase(seed: int, models: dict,
                      contig: Optional[dict] = None) -> dict:
    """MoE, SSM and hybrid stacks on gloo ranks sharing the card, on the
    streams the ``[moe]`` and ``[hybrid]`` phases built (no second init,
    no second PTQ): dbrx-132b (2 of 40 layers, published widths; its 16
    experts over ``model``: 8 a rank) and then mamba2-370m (full width and
    depth; ``in_proj`` cut into 2192 columns a rank and gathered, the
    mixer replicated, ``out_proj`` row-parallel) and hymba-1.5b (full;
    its 25 heads and 5 KV heads do not divide 2, so every model rank runs
    the whole attention block over its page slice of all 5 KV heads,
    while the Mamba2 mixer and the FFN are cut as mamba2's; its vocab
    32001 replicates too) at (2, 2); each on 4 of the serve phase's
    prompts with 12 new tokens. On every rank: the tokens of one process
    serving the same streams and requests eagerly, the decode qmm
    launched for dbrx and mamba2 and the attention kernel for dbrx and
    hymba (and every kernel the one process's run launched), qmm's "ref"
    path exactly as often as ``qmm_plan`` sends the model's leaves there
    a step call (hymba's ``w_up`` / ``w_gate`` streams, whose 2752-column
    cut would split a subtile, stay whole on a rank); a dbrx rank holds
    half the expert codes; a hymba rank's arena holds every KV head.
    Rank 0's collectives a round by kind and the phase's seconds are
    printed. ``models`` maps an arch to ``(cfg, qparams,
    ref_per_call)``. ``contig`` (``[mesh-contig]``) maps whisper-medium
    and internvl2-2b to the [families] phase's streams, batch and one
    process's logits and tokens; the same spawn's ranks run their
    contiguous prefill and decode after the served archs
    (``contig_rank``, ``check_contig``)."""
    t_phase = time.monotonic()
    out = {}
    jobs = {}
    for arch, (cfg, qparams, ref_per_call) in models.items():
        reqs = make_requests(cfg, 4, seed)
        for r in reqs:
            r.max_new_tokens = 12
        eng = serve_engine(cfg, qparams, cuda_graphs=False)
        ref_reqs = [dataclasses.replace(r, out_tokens=[]) for r in reqs]
        build.reset_launches()
        kops.reset_path_counts()
        t0 = time.monotonic()
        eng.run(ref_reqs)
        torch.cuda.synchronize()
        one = dict(tokens=[r.out_tokens for r in ref_reqs],
                   launches=dict(build.launches),
                   paths=dict(kops.path_counts), rounds=eng.stats.rounds,
                   seconds=time.monotonic() - t0,
                   expert_bytes=expert_codes(qparams))
        del eng
        torch.cuda.empty_cache()
        print(f"[mesh-x] {arch} one process, eager: {len(reqs)} requests x "
              f"12 tokens, {one['rounds']} rounds in {one['seconds']:.1f}s; "
              f"launches {one['launches']}; qmm paths {one['paths']}")
        out[arch] = dict(one=one)
        jobs[arch] = dict(cfg=cfg, qparams=qparams, requests=reqs)
    for shape, archs in FAMILY_MESH:
        t0 = time.monotonic()
        res = spawn(family_mesh_rank, shape, backend="gloo",
                    args=(dict(order=archs,
                               models={a: jobs[a] for a in archs},
                               contig=dict(contig or {})),),
                    timeout_s=600.0)
        label = f"({shape[0]},{shape[1]})"
        for arch in archs:
            one, ref_per_call = out[arch]["one"], models[arch][2]
            for r in res:
                got = r["archs"][arch]
                tag = f"mesh-x {arch} {label} rank {r['rank']}"
                require(got["tokens"] == one["tokens"], f"{tag}: tokens "
                        f"differ from one process's on the same streams")
                need = set(FAMILY_KERNELS[arch]) | {
                    k for k, n in one["launches"].items() if n}
                for k in need:
                    require(got["launches"][k] > 0, f"{tag}: kernel {k} "
                            f"never launched")
                require(got["paths"]["ref"] == ref_per_call * got["rounds"],
                        f"{tag}: qmm's 'ref' path {got['paths']['ref']} "
                        f"times, the plan sends {ref_per_call} leaves there "
                        f"a step call ({got['rounds']} calls)")
                c = models[arch][0]
                if c.n_kv_heads:
                    want = c.kv_dim if attn_replicated(c, shape[1]) \
                        else c.kv_dim // shape[1]
                    require(got["kv_width"] == want, f"{tag}: its arena "
                            f"holds {got['kv_width']} KV columns, not "
                            f"{want}")
                if one["expert_bytes"]:
                    require(2 * got["expert_bytes"] == one["expert_bytes"],
                            f"{tag}: holds {got['expert_bytes']} B of expert "
                            f"codes, not half of {one['expert_bytes']}")
            r0 = res[0]["archs"][arch]
            per_round = {k: f"{v[0] / r0['rounds']:.1f} "
                            f"({v[1] / r0['rounds'] * 1e3:.2f} ms, "
                            f"{v[2] / r0['rounds'] / 1e6:.3f} MB)"
                         for k, v in sorted(r0["by_kind"].items())}
            held = (f"; rank 0 holds {r0['expert_bytes'] / 1e9:.3f} GB of "
                    f"the {one['expert_bytes'] / 1e9:.3f} GB of expert "
                    f"codes" if one["expert_bytes"] else "")
            print(f"[mesh-x] {arch} {label} gloo, {len(res)} ranks on one "
                  f"card: every rank's tokens equal one process's; rank 0: "
                  f"{r0['tokens_out']} tokens, {r0['rounds']} rounds, "
                  f"{r0['wall_s']:.3f}s ({r0['tokens_per_s']:.1f} tok/s, "
                  f"round ms p50 {r0['round_ms_p50']:.2f}); collectives a "
                  f"round by kind (calls, seconds, payload): {per_round}; "
                  f"launches {r0['launches']}; qmm paths {r0['paths']}; "
                  f"arena KV columns {r0['kv_width']}; set-up "
                  f"{r0['setup_s']:.1f}s{held}")
            out[arch][label] = dict(r0, ranks=len(res), tokens=None)
        if contig:
            out["contig"] = check_contig(res, contig, shape)
        torch.cuda.ipc_collect()
        out[f"spawn {label}"] = dict(
            seconds=time.monotonic() - t0,
            rank_s=[r["rank_s"] for r in res])
        print(f"[mesh-x] {label} spawn to join "
              f"{time.monotonic() - t0:.1f}s")
    out["seconds"] = time.monotonic() - t_phase
    print(f"[mesh-x] phase {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 4f: the contiguous-cache surface (encoder-decoder, VLM, legacy)
# ---------------------------------------------------------------------------
FAMILY_PROMPT, FAMILY_STEPS = 16, 16


def family_run(cfg, qparams, toks, extra, use_kernels, feed=None):
    """``prefill`` over the prompt, then ``FAMILY_STEPS`` greedy
    ``decode_step`` calls (fed ``feed``'s tokens when given, so a second
    run follows the first one's positions); returns the logits of every
    call [B, 1 + steps, V] and the tokens fed."""
    b = toks.shape[0]
    n_vis = cfg.n_vis_tokens if "vis_embeds" in extra else 0
    max_len = n_vis + FAMILY_PROMPT + FAMILY_STEPS + 1
    lg, cache = prefill(cfg, qparams, toks, max_len=max_len,
                        cache_dtype=torch.float32, use_kernels=use_kernels,
                        **extra)
    logits, fed = [lg], []
    for i in range(FAMILY_STEPS):
        nxt = (feed[:, i] if feed is not None
               else torch.argmax(logits[-1], dim=-1))
        fed.append(nxt)
        lg, cache = decode_step(cfg, qparams, nxt.reshape(b, 1), cache,
                                n_vis + FAMILY_PROMPT + i,
                                use_kernels=use_kernels)
        logits.append(lg)
    return torch.stack(logits, dim=1), torch.stack(fed, dim=1)


def family_arch(arch: str, seed: int, kept: Optional[dict] = None) -> dict:
    """One family at its published width: kernels against plain versions
    over prefill and 16 decode steps, decode against one full forward, and
    the encoder's time and qmm route. With ``kept`` the streams, the
    batch and the kernels' logits and tokens stay there for
    ``[mesh-contig]``."""
    cfg = get_config(arch)
    t0 = time.monotonic()
    params = init_params(cfg, seed, device="cuda")
    qparams = quantize_for_serving(params, QMCConfig(
        rho=0.3, granularity="subtile"), min_dim=64)
    del params
    torch.cuda.synchronize()
    print(f"[families] {arch} full width ({cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder layers over {cfg.enc_seq} "
             f"frames" if cfg.is_encdec else "")
          + (f", {cfg.n_vis_tokens} vision embeddings" if cfg.n_vis_tokens
             else "")
          + f", d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, vocab "
          f"{cfg.vocab}): init + QMC PTQ on the card in "
          f"{time.monotonic() - t0:.1f}s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)
    b = 2
    toks = torch.randint(2, cfg.vocab, (b, FAMILY_PROMPT), generator=gen,
                         device="cuda")
    extra = {}
    if cfg.is_encdec:
        extra["frames"] = 0.1 * torch.randn((b, cfg.enc_seq, cfg.d_model),
                                            generator=gen, device="cuda")
    if cfg.n_vis_tokens:
        extra["vis_embeds"] = 0.1 * torch.randn(
            (b, cfg.n_vis_tokens, cfg.d_model), generator=gen,
            device="cuda")
    build.reset_launches()
    kops.reset_path_counts()
    lk, fed = family_run(cfg, qparams, toks, extra, True)
    torch.cuda.synchronize()
    launches, paths = dict(build.launches), dict(kops.path_counts)
    require(launches["qmm_decode"] > 0, f"{arch}: the decode qmm never "
            f"launched")
    lp, _ = family_run(cfg, qparams, toks, extra, False, feed=fed)
    torch.cuda.synchronize()
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    require(bool(torch.isfinite(lk).all()), f"{arch}: non-finite logits")
    require(diff <= 1e-3 * scale, f"{arch}: prefill + decode logits "
            f"through the kernels differ from the plain versions by "
            f"{diff:.3e} > 1e-3 * max|logits| = {1e-3 * scale:.3e}")
    full = forward(cfg, qparams, torch.cat([toks, fed], dim=1), **extra)
    at = full[:, FAMILY_PROMPT - 1:FAMILY_PROMPT + FAMILY_STEPS]
    f_diff = (lk - at).abs().max().item()
    require(f_diff <= 1e-3 * scale, f"{arch}: decode logits differ from "
            f"the full forward's by {f_diff:.3e} > 1e-3 * max|logits| = "
            f"{1e-3 * scale:.3e}")
    print(f"[families] {arch}: prefill + {FAMILY_STEPS} greedy decode "
          f"steps, batch {b}: kernels vs plain max|logits diff| {diff:.3e}, "
          f"decode vs one full forward {f_diff:.3e} (1e-3 * max|logits| "
          f"{1e-3 * scale:.3e}); kernel launches {launches}; qmm paths "
          f"{paths}")
    out = dict(max_abs_diff=diff, forward_diff=f_diff, max_abs_logit=scale,
               launches=launches, qmm_paths=paths)
    if cfg.is_encdec:
        rows = b * cfg.enc_seq
        route = kops.qmm_plan(rows, cfg.d_model, cfg.d_model,
                              (8, 128))["path"]
        kops.reset_path_counts()
        encode(cfg, qparams, extra["frames"])
        torch.cuda.synchronize()
        enc_paths = dict(kops.path_counts)
        timer = Timer(runs=5, warmup=1)
        enc_ms = timer(lambda: encode(cfg, qparams, extra["frames"]))
        del timer
        print(f"[families] {arch} encoder: {cfg.n_enc_layers} layers over "
              f"{b} x {cfg.enc_seq} frames in {enc_ms:.2f} ms; its "
              f"projections at M = {rows} take qmm's {route!r} route "
              f"(padded M {kops.qmm_plan(rows, cfg.d_model, cfg.d_model, (8, 128))['pad_m']}"
              f", not a multiple of 128); qmm paths of one encode "
              f"{enc_paths}")
        out.update(encoder_ms=enc_ms, encoder_route=route,
                   encoder_paths=enc_paths)
    if kept is not None:
        kept[arch] = dict(cfg=cfg, qparams=qparams, toks=toks, extra=extra,
                          logits=lk, fed=fed)
    del qparams, full, lk, lp
    torch.cuda.empty_cache()
    return out


def legacy_vs_paged(cfg, qparams, seed: int, paged_tokens) -> dict:
    """``LegacyServeEngine`` on the serve phase's weights and 8 requests
    against the paged engine's tokens: attention through the plain
    ``attend`` over per-slot caches against the ragged kernel. Where a
    request's tokens part, the legacy logits at that position must be a
    near tie: a top-2 gap below 1e-3 * max|logits|."""
    eng = LegacyServeEngine(cfg, qparams, slots=4, max_len=256,
                            device="cuda")
    reqs = make_requests(cfg, 8, seed)
    eng.run(reqs)
    torch.cuda.synchronize()
    s = eng.stats
    parted = []
    for r, want in zip(reqs, paged_tokens):
        if r.out_tokens == want:
            continue
        j = next(i for i, (a, b) in enumerate(zip(r.out_tokens, want))
                 if a != b)
        seq = np.concatenate([r.prompt, r.out_tokens[:j]]).astype(np.int64)
        lg, _ = prefill(cfg, qparams, torch.as_tensor(seq[None],
                                                      device="cuda"),
                        max_len=len(seq), cache_dtype=torch.float32)
        top = torch.topk(lg[0], 2).values
        gap = (top[0] - top[1]).item()
        scale = lg.abs().max().item()
        print(f"[families] legacy vs paged: request {r.uid} parts at output "
              f"position {j} ({r.out_tokens[j]} vs {want[j]}); top-2 logit "
              f"gap there {gap:.3e} vs 1e-3 * max|logits| {1e-3 * scale:.3e}")
        require(gap < 1e-3 * scale, f"legacy vs paged: request {r.uid} "
                f"parts at position {j} with a top-2 gap of {gap:.3e}")
        parted.append(dict(uid=r.uid, position=j, gap=gap, scale=scale))
    same = sum(r.out_tokens == w for r, w in zip(reqs, paged_tokens))
    print(f"[families] LegacyServeEngine stablelm-1.6b: {s.prefills} "
          f"prefills, {s.decode_steps} decode calls, {s.tokens_out} tokens "
          f"in {s.wall_s:.2f}s ({s.tokens_per_s:.1f} tok/s); {same} of "
          f"{len(reqs)} requests token-identical to the paged engine's")
    return dict(prefills=s.prefills, decode_steps=s.decode_steps,
                tokens=s.tokens_out, wall_s=s.wall_s,
                tokens_per_s=s.tokens_per_s, identical=same, parted=parted)


def dryrun_phase() -> dict:
    """``[dryrun]``, on the host alone: ``launch.dryrun.run_cell`` for
    stablelm-1.6b's train_4k, prefill_32k and decode_32k cells on the
    single-node production mesh (32 nodes of 8 H100s), rank 0: its
    counted work, collectives by kind, argument bytes and roofline terms
    against the H100 SXM5 datasheet's peaks (not measurements)."""
    t0 = time.monotonic()
    out = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("stablelm-1.6b", shape, multi_pod=False)
        require(rec["ok"], f"dryrun stablelm-1.6b {shape}: "
                f"{rec.get('error')}")
        roof = rec["roofline"]
        kinds = {k: f"{v['calls']} ({v['bytes'] / 1e6:.1f} MB)"
                 for k, v in rec["collectives"].items()}
        print(f"[dryrun] stablelm-1.6b {shape} on {rec['mesh']} (32 x 8 "
              f"H100), rank 0, counted on meta in {rec['run_s']:.2f}s: "
              f"{rec['cost']['flops'] / 1e12:.3f} TFLOP, "
              f"{rec['cost']['bytes accessed'] / 1e9:.3f} GB; collectives "
              f"by kind (calls, payload) {kinds}; argument bytes "
              f"{rec['memory']['argument_bytes'] / 1e9:.3f} GB; roofline "
              f"against datasheet peaks (not measurements): compute "
              f"{roof['t_compute'] * 1e3:.3f} ms, memory "
              f"{roof['t_memory'] * 1e3:.3f} ms, collective "
              f"{roof['t_collective'] * 1e3:.3f} ms -> "
              f"{roof['bottleneck']}, roofline fraction "
              f"{roof['roofline_fraction']:.3f}")
        out[shape] = {k: rec[k] for k in ("cost", "collectives", "memory",
                                           "roofline", "run_s")}
    out["seconds"] = time.monotonic() - t0
    print(f"[dryrun] phase {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 4h: the head dims 80 and 256 on the engine's default route
# ---------------------------------------------------------------------------
ATTN_HD_LAYERS = 2      # gemma2-2b's 2 layers: one (local, global) group


def attn_hd_arch(arch: str, seed: int) -> dict:
    """``arch`` at its published width, depth cut to ``ATTN_HD_LAYERS``,
    QMC PTQ on the card: the serve requests eager and graphed through the
    paged engine (paged attention on fp32 pages, the default route; tokens
    identical, every serving kernel launched, qmm's "ref" path as its plan
    says), then one whole step through the kernels against the plain
    versions."""
    cfg = dataclasses.replace(get_config(arch), n_layers=ATTN_HD_LAYERS)
    t0 = time.monotonic()
    params = init_params(cfg, seed, device="cuda")
    qparams = quantize_for_serving(params, QMCConfig(
        rho=0.3, granularity="subtile"), min_dim=64)
    del params
    torch.cuda.synchronize()
    calls, shapes = qmm_plan_calls(qparams)
    print(f"[attn-hd] {arch} full width, {cfg.n_layers} of "
          f"{get_config(arch).n_layers} layers (pattern {cfg.pattern}, d "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, hd "
          f"{cfg.head_dim}, window {cfg.window}, attention softcap "
          f"{cfg.attn_softcap}, vocab {cfg.vocab}): init + QMC PTQ on the "
          f"card in {time.monotonic() - t0:.1f}s; QTensor matmuls a step "
          f"call {calls} ({shapes})")
    out, toks = {}, {}
    for label, kw in SERVE_RUNS[:2]:
        out[label], toks[label], eng = serve(
            cfg, qparams, seed, f"{arch} {label}", ref_per_call=calls["ref"],
            tag="attn-hd", **kw)
        del eng
        torch.cuda.empty_cache()
    require(toks[SERVE_RUNS[1][0]] == toks[SERVE_RUNS[0][0]],
            f"attn-hd {arch}: graphed tokens differ from the eager run's")
    print(f"[attn-hd] {arch}: identical tokens eager and graphed")
    out["step"] = whole_step(cfg, qparams, seed, tag="attn-hd")
    del qparams
    torch.cuda.empty_cache()
    return out


def attn_hd_phase(seed: int) -> dict:
    return {arch: attn_hd_arch(arch, seed)
            for arch in ("stablelm-3b", "gemma2-2b")}


# ---------------------------------------------------------------------------
# phase 6: the PTQ entry point at full width
# ---------------------------------------------------------------------------
def check_unpack3b(timer, peak, gen, rows):
    """unpack3b against its plain version, bit-exact, at UNPACK_SIZES.
    Bound: 3n/8 bytes read and 4n written; its 3 integer operations per
    code (shift, mask, subtract) at the fp32 rate are never the limit."""
    for n in UNPACK_SIZES:
        codes = torch.randint(-4, 4, (n,), generator=gen, device="cuda",
                              dtype=torch.int32)
        packed = pack_codes(codes, 3)
        got = unpack3b_call(packed, n)
        want = unpack3b_ref(packed, n)
        torch.cuda.synchronize()
        require(torch.equal(got, want) and torch.equal(got, codes),
                f"unpack3b n={n}: differs from its plain version")
        ms = timer(lambda: unpack3b_call(packed, n))
        host_ms = timer.host(lambda: unpack3b_call(packed, n))
        plain_ms = timer(lambda: unpack3b_ref(packed, n))
        b_ms, b_by = bound(3 * n // 8 + 4 * n, 3.0 * n, *peak[:2])
        rows.append(dict(kernel="unpack3b", shape=f"n={n}",
                         dtype="uint8->int32", max_abs_err=0.0, ms=ms,
                         host_ms=host_ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by))
        print(f"[ptq] unpack3b n={n:11d} bit-exact ms={ms:.4f} "
              f"host={host_ms:.4f} plain={plain_ms:.4f} "
              f"bound={b_ms:.4f} ({b_by}); no single library call")
        del codes, packed, got, want


def drift(ref: torch.Tensor, out: torch.Tensor) -> float:
    """examples/quickstart.py's relative logit drift."""
    return float((ref - out).abs().mean() / (ref.abs().mean() + 1e-9))


def ptq_quickstart(cfg, seed: int):
    """examples/quickstart.py at full width on the card: every ported
    quantize_model method, the cache-less forward over one 2 x 256 batch.
    That forward also captures the calibration taps GPTQ and AWQ take (as
    the paper's table 3 does). At most two full-width trees (the dense
    one and one quantized) live on the card at a time."""
    params = init_params(cfg, seed, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(2, 256)), device="cuda")
    taps = {}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ref = forward(cfg, params, toks, taps=taps)
    torch.cuda.synchronize()
    print(f"[ptq] calibration taps: {len(taps)} keys of "
          f"{sorted({v.shape[0] for v in taps.values()})} rows, "
          f"{sum(v.numel() for v in taps.values()) * 4 / 2**20:.0f} MiB, "
          f"captured with the reference forward in "
          f"{time.monotonic() - t0:.2f}s")
    qmc = QMCConfig(rho=0.3, bits_in=3, bits_out=5, cell_bits=3)
    out = {}
    for label, method, noisy in PTQ_METHODS:
        noise_gen = None
        if noisy:
            noise_gen = torch.Generator(device="cuda")
            noise_gen.manual_seed(seed + 7)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        q = quantize_model(params, method, qmc=qmc, noise_gen=noise_gen,
                           min_dim=64,
                           taps=taps if method in ("gptq", "awq") else None)
        torch.cuda.synchronize()
        ptq_s = time.monotonic() - t0
        logits = forward(cfg, q, toks)
        require(bool(torch.isfinite(logits).all()),
                f"{label}: non-finite logits")
        d = drift(ref, logits)
        bpw = model_bits_per_weight(params, method, qmc)
        print(f"[ptq] {label:16s} PTQ {ptq_s:7.2f}s  logit drift {d:.4f}  "
              f"bits/weight {bpw:.3f}")
        out[label] = dict(ptq_s=ptq_s, drift=d, bits_per_weight=bpw)
        del q, logits
    require(out["qmc"]["drift"] < out["rtn4"]["drift"],
            f"QMC drift {out['qmc']['drift']:.4f} is not below RTN-INT4's "
            f"{out['rtn4']['drift']:.4f}")
    print(f"[ptq] QMC < RTN-INT4 drift, as examples/quickstart.py asserts; "
          f"{16 / qmc.avg_bits:.2f}x logical compression of quantized "
          f"layers; against RTN-INT4 (reported, not required): GPTQ "
          f"{out['gptq']['drift'] / out['rtn4']['drift']:.3f}x, AWQ "
          f"{out['awq']['drift'] / out['rtn4']['drift']:.3f}x its drift")
    del taps, params, ref
    torch.cuda.empty_cache()
    return out


def qtensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from qtensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from qtensors(v)
    elif isinstance(tree, QTensor):
        yield tree


def reram_read_path(qparams):
    """Every inlier stream of the serving QTensors packed to 3 bits on the
    card and decoded through kernels.ops.unpack3b, bit-exact."""
    packed_total = inlier_term = nbytes_packed = nbytes_container = 0
    n_streams = 0
    for qt in qtensors(qparams):
        n = qt.in_codes.numel()
        packed = pack_codes(qt.in_codes, 3)
        require(packed.numel() == packed_nbytes(n, 3),
                f"packed {packed.numel()} bytes for {n} codes")
        codes = kops.unpack3b(packed, n)
        require(torch.equal(codes, qt.in_codes.reshape(-1).to(torch.int32)),
                f"unpack3b: stream {n_streams} ({qt.shape}) does not "
                f"decode to its in_codes")
        packed_total += packed.numel()
        inlier_term += n * qt.bits_in / 8
        nbytes_packed += qt.nbytes_packed()
        nbytes_container += qt.nbytes_container()
        n_streams += 1
    torch.cuda.synchronize()
    print(f"[ptq] ReRAM read path: {n_streams} inlier streams packed to "
          f"{packed_total} bytes (inlier term of nbytes_packed "
          f"{inlier_term:.0f}); decoded bit-exact; nbytes_packed "
          f"{nbytes_packed}, int8 containers {nbytes_container}")
    return dict(streams=n_streams, packed_bytes=packed_total,
                inlier_term=inlier_term, nbytes_packed=nbytes_packed,
                nbytes_container=nbytes_container)


def fig4_rows(arch: str = "hymba-1.5b", seq: int = 1024):
    """benchmarks/fig4.py's rows from the port's memsys."""
    cfg = get_config(arch)
    sys_cfg = memsys.MemSystemConfig()
    res = {}
    for m in ("fp16", "rtn4", "awq", "gptq", "mx4"):
        legacy = m == "fp16"
        res[m] = memsys.evaluate_conventional(
            memsys.make_traffic(cfg, m, seq_len=seq, legacy_flash=legacy),
            sys_cfg, legacy_flash=legacy)
    for cell_bits, name in ((3, "qmc_3bit"), (2, "qmc_2bit")):
        t = memsys.make_traffic(cfg, "qmc", seq_len=seq, qmc=QMCConfig(
            rho=0.3, cell_bits=cell_bits))
        res[name] = memsys.evaluate_hetero(t, memsys.dse(
            t, cell_bits=cell_bits))
    base = res["fp16"]
    out = {}
    for name, r in res.items():
        out[name] = dict(
            energy_mJ=r.energy_j * 1e3, latency_ms=r.latency_s * 1e3,
            vs_fp16_energy=base.energy_j / r.energy_j,
            vs_fp16_latency=base.latency_s / r.latency_s,
            vs_fp16_cells=base.capacity_cells / r.capacity_cells)
        print(f"[ptq] fig4/{arch}/{name:9s} energy {r.energy_j * 1e3:8.3f} "
              f"mJ  latency {r.latency_s * 1e3:7.3f} ms  vs fp16: energy "
              f"{out[name]['vs_fp16_energy']:6.2f}x latency "
              f"{out[name]['vs_fp16_latency']:6.2f}x cells "
              f"{out[name]['vs_fp16_cells']:5.2f}x")
    return out


# ---------------------------------------------------------------------------
# phase 7: training on one card
# ---------------------------------------------------------------------------
TRAIN_STEPS, TRAIN_WARMUP = 8, 2
TRAIN_BATCH, TRAIN_SEQ = 8, 128


def check_ce_losses(cfg, seed: int) -> dict:
    """``chunked_ce_loss`` and ``sharded_ce_loss`` against
    ``cross_entropy_loss`` over the full logits, loss and gradients, at
    the model's vocab and width on the card (fp32 products)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)
    x = torch.randn((2, 256, cfg.d_model), generator=gen, device="cuda")
    w = torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                    device="cuda") * cfg.d_model ** -0.5
    labels = torch.randint(0, cfg.vocab, (2, 256), generator=gen,
                           device="cuda")

    def grads(fn):
        xs = x.clone().requires_grad_(True)
        ws = w.clone().requires_grad_(True)
        loss = fn(xs, ws)
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), xs.grad, ws.grad

    ref = grads(lambda xs, ws: cross_entropy_loss(xs @ ws, labels))
    out = {}
    for name, fn in (("chunked_ce_loss", lambda xs, ws: chunked_ce_loss(
                         xs, ws, labels)),
                     ("sharded_ce_loss", lambda xs, ws: sharded_ce_loss(
                         xs, ws, labels))):
        got = grads(fn)
        d_loss = abs(got[0].item() - ref[0].item()) / abs(ref[0].item())
        d_g = [((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(got[1:], ref[1:])]
        require(d_loss <= 1e-5 and max(d_g) <= 1e-4,
                f"[train] {name}: loss off by {d_loss:.2e} (rel), grads "
                f"by {d_g} (x max|g|) against cross_entropy_loss")
        print(f"[train] {name} at vocab {cfg.vocab}, d {cfg.d_model}, "
              f"T = 512: loss {got[0].item():.6f} vs {ref[0].item():.6f} "
              f"(rel {d_loss:.2e}); max|dx diff| {d_g[0]:.2e}, max|dw "
              f"diff| {d_g[1]:.2e} of max|g|")
        out[name] = dict(loss_rel=d_loss, dx_rel=d_g[0], dw_rel=d_g[1])
    return out


def train_phase(cfg, seed: int) -> dict:
    """``train()`` at full width and depth in fp32 on the card: batch
    TRAIN_BATCH x TRAIN_SEQ of the synthetic corpus, TRAIN_STEPS steps
    after a TRAIN_WARMUP-step warmup (step 0 at lr 0, as the reference).
    Every loss finite, the last steps' mean below the first step's loss,
    the parameters moved."""
    out = {"ce": check_ce_losses(cfg, seed)}
    probe = init_params(cfg, seed, device="cuda")
    before = {k: probe["blocks"]["b0"]["attn"][k][0].clone()
              for k in ("wq", "wo")}
    del probe
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    res = train(cfg, TrainConfig(steps=TRAIN_STEPS,
                                 global_batch=TRAIN_BATCH,
                                 seq_len=TRAIN_SEQ, warmup=TRAIN_WARMUP,
                                 log_every=1, seed=seed),
                AdamWConfig(lr=1e-3), device="cuda",
                log_fn=lambda m: print(m.replace("[trainer]", "[train]")))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    # train() resets the peak before each step and keeps it per step
    peak = max(h["peak_bytes"] for h in res["history"]) - base
    losses = [h["loss"] for h in res["history"]]
    ms = [h["time_s"] * 1e3 for h in res["history"]]
    require(len(losses) == TRAIN_STEPS
            and all(np.isfinite(x) for x in losses),
            f"[train] losses not all finite: {losses}")
    require(np.mean(losses[-2:]) < losses[0], f"[train] the last steps' "
            f"loss {np.mean(losses[-2:]):.4f} is not below the first "
            f"step's {losses[0]:.4f}")
    moved = {k: (res["params"]["blocks"]["b0"]["attn"][k][0]
                 - v).abs().max().item() for k, v in before.items()}
    require(all(d > 0 for d in moved.values()),
            f"[train] parameters did not move: {moved}")
    n_params = sum(t.numel() for t in tree_leaves(res["params"]))
    print(f"[train] stablelm-1.6b full width and depth ({n_params / 1e9:.3f}"
          f" B parameters, fp32, AdamW fp32 moments), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: {TRAIN_STEPS} steps in {wall:.1f}s; ms a step "
          f"{[round(x, 1) for x in ms]} (median after the first "
          f"{float(np.median(ms[1:])):.1f}); peak memory "
          f"{peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held "
          f"before; losses {[round(x, 4) for x in losses]}; "
          f"max|change| of b0 wq / wo {moved}")
    out.update(losses=losses, step_ms=ms, wall_s=wall, peak_bytes=peak,
               n_params=n_params, moved=moved,
               grad_norm=[h["grad_norm"] for h in res["history"]])
    del res
    torch.cuda.empty_cache()
    return out


TRAIN_MESH_STEPS, TRAIN_MESH_SHAPE = 3, (2, 2)
# 4 of stablelm-1.6b's 24 layers: the dense path's per-layer work is the
# same at any depth, and the time went to [train-mesh-x]
TRAIN_MESH_LAYERS = 4
# (2, 2) against one process: fp32 sums split over ranks and reduced in
# another order differ in the last bits, and AdamW's m / sqrt(v) turns a
# last-bit difference of a near-zero gradient into a whole lr-sized step
# of that entry (ROADMAP C, hazards), which the next steps' losses carry
TRAIN_MESH_RTOL = {"loss": 1e-6, "grad_norm": 1e-5}
# step 0's gradients, before any update (so no AdamW hazard): each leaf's
# norm and projection against one process's, over the leaf's norm plus
# TRAIN_MESH_GRAD_FLOOR x the whole gradient's norm. Read up to 5.6e-6
# on the card (the key bias, then the embedding at 4.4e-6), so the limit
# is 3.6x that; a bias missing its SUM over model reads 0.5 (a 2-layer
# CPU run)
TRAIN_MESH_GRAD_TOL, TRAIN_MESH_GRAD_FLOOR = 2e-5, 1e-4


def tree_fingerprints(grads, seed: int, mesh=None, specs=None) -> dict:
    """``{path: (norm, projection)}`` of the whole gradients that this
    rank's slices make up (a gradient tree in one process without a
    mesh), in float64: a leaf's projection on ``u_0 x u_1 x ... x u_k``,
    normal vectors drawn from ``seed`` for each dim of the whole leaf, so
    that a rank contracts its slice with its slices of them and the sums
    over the ranks that own a slice (``sharding.owns``) are the whole
    leaf's: one all_reduce for the tree, and no gradient gathered. A
    dropped or doubled sum, or a wrong scale, sign or place of a leaf's
    gradient moves its norm or its projection. Every rank of a mesh must
    call it."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding as shd
    dev = tree_leaves(grads)[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(device=dev, dtype=torch.float64)
    paths, sums = [], []
    for path, g in tree_items(grads):
        spec = specs[path] if mesh is not None else ()
        shape = list(g.shape)
        for dim, ax in enumerate(spec):
            shape[dim] *= meshlib.axis_size(mesh, ax)
        us = [torch.randn(n, generator=gen, **f64) for n in shape]
        if mesh is not None:
            us = [u[i] for u, i in zip(us, shd.local_slices(spec, shape,
                                                            mesh))]
        rows = g.reshape(-1, g.shape[-1])
        w = torch.ones(1, **f64)
        for u in us[:-1]:
            w = torch.outer(w, u).reshape(-1)
        sq = proj = torch.zeros((), **f64)
        step = max(1, (1 << 24) // rows.shape[1])
        for a in range(0, rows.shape[0], step):
            c = rows[a:a + step].double()
            sq = sq + (c * c).sum()
            proj = proj + (w[a:a + step] * (c @ us[-1])).sum()
        keep = mesh is None or shd.owns(spec, mesh)
        paths.append(path)
        sums.append(torch.stack([sq, proj]) * float(keep))
    total = torch.stack(sums)
    if mesh is not None:
        mesh.all_reduce(total, "all", kind="unshard")
    total = total.cpu().tolist()
    return {p: (float(np.sqrt(sq)), proj) for p, (sq, proj) in
            zip(paths, total)}


def grad_fingerprints(mesh, cfg, seed: int):
    """Step 0's gradients of the sharded step (``mesh_grads_fn``, remat
    on) on this rank's slices of the tree initialised from the seed and
    the corpus's step-0 batch; on rank 0 ``{"leaves":
    tree_fingerprints, "loss", "aux"}``, None on the other ranks; the
    mesh's collective counts are set back to 0."""
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    from repro_torch.launch import sharding as shd
    from repro_torch.train.step import mesh_grads_fn
    compute = mesh_grads_fn(cfg, mesh, remat=True)
    params = shd.train_slices(init_params(cfg, seed, device="cuda"), mesh,
                              compute.specs)
    rows = shd.batch_rows(mesh, TRAIN_BATCH)
    batch = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=seed + 1)
                            ).sample_batch(TRAIN_BATCH, TRAIN_SEQ, step=0)
    batch = {k: torch.from_numpy(v[rows]).long().cuda()
             for k, v in batch.items()}
    batch.update({k: v[rows].cuda() for k, v in extra_batch(
        TRAIN_BATCH, TRAIN_SEQ, cfg).items()})
    loss, metrics, grads = compute(params, batch)
    del params
    leaves = tree_fingerprints(grads, seed, mesh, compute.specs)
    del grads
    torch.cuda.empty_cache()
    mesh.reset_counts()
    if mesh.rank != 0:
        return None
    return {"leaves": leaves, "loss": float(loss),
            "aux": float(metrics["aux"])}


def compare_fingerprints(tag: str, got: dict, want: dict, tol: float,
                         floor: float, what: str = "") -> dict:
    """The worst leaves of ``got`` against ``want`` (``grad_fingerprints``
    leaves): ``max(|norm diff|, |projection diff|)`` over the leaf's norm
    plus ``floor`` x the whole gradient's norm; printed, and required
    within ``tol``. Returns the six worst."""
    tag = f"{tag}] [{what}" if what else tag
    require(set(got) == set(want), f"[{tag}] the sharded step's gradients "
            f"hold other leaves than one process's")
    whole = float(np.sqrt(sum(n * n for n, _ in want.values())))
    errs = {}
    for path, (n1, p1) in want.items():
        nm, pm = got[path]
        errs[path] = max(abs(nm - n1), abs(pm - p1)) / (n1 + floor * whole)
    worst = sorted(errs, key=errs.get, reverse=True)[:6]
    print(f"[{tag}] step 0's gradients, {len(errs)} leaves (norm, "
          f"projection of the whole leaf) against one process's, the "
          f"worst: " +
          "; ".join(f"{p} {got[p][0]:.9g} vs {want[p][0]:.9g}, "
                    f"{got[p][1]:.9g} vs {want[p][1]:.9g}: {errs[p]:.2e}"
                    for p in worst) +
          f" (the whole gradient's norm {whole:.6g}; tol {tol} of a leaf's "
          f"norm + {floor} x the whole's)")
    require(max(errs.values()) <= tol,
            f"[{tag}] step 0's gradient of {worst[0]} is off one "
            f"process's by {errs[worst[0]]:.2e} > {tol}")
    return {p: errs[p] for p in worst}


def extra_batch(batch: int, seq: int, cfg) -> dict:
    """A global batch's ``frames`` (an encoder-decoder: ``enc_seq`` frame
    embeddings a row) or ``vis_embeds`` (a VLM: ``n_vis_tokens`` patch
    embeddings a row), on the host: normal values from a generator seeded
    with TRAIN_EXTRA_SEED, the same in every process and every step (the
    stand-in of the stubbed frontends). ``train``'s ``extra_batch_fn``."""
    gen = torch.Generator().manual_seed(TRAIN_EXTRA_SEED)
    out = {}
    if cfg.is_encdec:
        out["frames"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                    generator=gen)
    if cfg.n_vis_tokens:
        out["vis_embeds"] = torch.randn(
            (batch, cfg.n_vis_tokens, cfg.d_model), generator=gen)
    return out


def train_mesh_rank(mesh, job):
    """One rank of ``[train-mesh]``: ``train()`` on its slices (the whole
    tree initialised from the seed on the card, sliced, dropped), batch
    8 x 128 of the synthetic corpus (with ``extra_batch``'s frames or
    visual embeddings), remat on; its history (with each step's peak
    memory), the bytes of its parameter slices and of one gathered layer
    group, and the collectives by kind."""
    t0 = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tag = job["cfg"], job.get("tag", "train-mesh")
    fingerprint = grad_fingerprints(mesh, cfg, job["seed"])
    res = train(cfg, TrainConfig(steps=TRAIN_MESH_STEPS,
                                 global_batch=TRAIN_BATCH,
                                 seq_len=TRAIN_SEQ, warmup=TRAIN_WARMUP,
                                 log_every=1, seed=job["seed"]),
                AdamWConfig(lr=1e-3), mesh, device="cuda",
                log_fn=lambda m: print(m.replace("[trainer]",
                                                 f"[{tag}] {cfg.name}")),
                extra_batch_fn=(extra_batch if cfg.is_encdec
                                or cfg.n_vis_tokens else None))
    torch.cuda.synchronize()
    local = sum(t.numel() * t.element_size()
                for t in tree_leaves(res["params"]))
    group = sum(t[0].numel() * t.element_size()
                for t in tree_leaves(res["params"]["blocks"]))
    data = mesh.shape[list(mesh.axis_names).index("data")]
    rows = TRAIN_BATCH // data
    work = obs_costs.train_step_work(
        cfg, mesh, tokens=rows * TRAIN_SEQ, enc_tokens=rows * cfg.enc_seq
        if cfg.is_encdec else 0, vis_tokens=rows * cfg.n_vis_tokens)
    return dict(rank=mesh.rank, history=res["history"], local_bytes=local,
                flops=work["flops"],
                fingerprint=fingerprint,
                gathered_group_bytes=group * data,
                by_kind={k: list(v) for k, v in mesh.by_kind.items()},
                collectives=mesh.collectives,
                collective_s=mesh.collective_seconds,
                rank_s=time.monotonic() - t0)


def check_train_runs(tag: str, what: str, label: str, mesh_res, one,
                     grad_tol: float, rtol: dict) -> dict:
    """The ``train_mesh_rank`` results of a mesh's ranks against one
    process's: every rank's metrics rank 0's, step 0's gradients leaf by
    leaf within ``grad_tol`` (``compare_fingerprints``), the losses and
    grad norms within ``rtol``, each rank's peak within its slice of the
    one process's plus one gathered group and 1 GiB; printed with the ms
    a step and rank 0's collectives a step by kind."""
    out = {}
    r0 = mesh_res[0]
    for r in mesh_res:
        for k in ("loss", "grad_norm"):
            require([h[k] for h in r["history"]]
                    == [h[k] for h in r0["history"]],
                    f"[{tag}] {what} rank {r['rank']}'s {k} differ from "
                    f"rank 0's")
    out["grad_err"] = compare_fingerprints(
        tag, r0["fingerprint"]["leaves"], one["fingerprint"]["leaves"],
        grad_tol, TRAIN_MESH_GRAD_FLOOR, what)
    for k, tol in rtol.items():
        got = np.array([h[k] for h in r0["history"]])
        want = np.array([h[k] for h in one["history"]])
        rel = np.abs(got - want) / np.abs(want)
        require(np.all(np.isfinite(got)) and np.all(rel <= tol),
                f"[{tag}] {what} {label} {k} {got.tolist()} against one "
                f"process's {want.tolist()}: rel {rel.tolist()} > {tol}")
        out[f"{k}_rel"] = rel.tolist()
    # a rank holds its slice of what one process holds (parameters,
    # gradients, moments, the update's copies) plus one gathered group;
    # 1 GiB more for its activations and the gathered head
    one_peak = max(h["peak_bytes"] for h in one["history"])
    peaks = [max(h["peak_bytes"] for h in r["history"]) for r in mesh_res]
    bound = (one_peak * r0["local_bytes"] / one["local_bytes"]
             + r0["gathered_group_bytes"] + 2**30)
    require(max(peaks) <= bound,
            f"[{tag}] {what}: a rank's peak {max(peaks) / 2**30:.2f} GiB "
            f"is over its slice of one process's {one_peak / 2**30:.2f} "
            f"GiB plus a gathered group and 1 GiB ({bound / 2**30:.2f})")
    steps = len(r0["history"])
    kinds = {k: (v[0] / steps, v[1] / steps, v[2] / steps)
             for k, v in r0["by_kind"].items()}
    ms = [h["time_s"] * 1e3 for h in r0["history"]]
    one_ms = [h["time_s"] * 1e3 for h in one["history"]]
    print(f"[{tag}] {what}, batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat, "
          f"{label} gloo ranks on one card: losses "
          f"{[h['loss'] for h in r0['history']]} grad norms "
          f"{[h['grad_norm'] for h in r0['history']]}; one process (1,1): "
          f"losses {[h['loss'] for h in one['history']]} grad norms "
          f"{[h['grad_norm'] for h in one['history']]}; rel "
          f"{out['loss_rel']} / {out['grad_norm_rel']} (rtol {rtol})")
    print(f"[{tag}] {what}: ms a step: {label} "
          f"{[round(x, 1) for x in ms]}, one process "
          f"{[round(x, 1) for x in one_ms]}; counted matmul TFLOP a step "
          f"(obs.costs.train_step_work): a rank {r0['flops'] / 1e12:.3f}, "
          f"one process {one['flops'] / 1e12:.3f}")
    print(f"[{tag}] {what}: peak memory a step (GiB): ranks "
          f"{[round(p / 2**30, 3) for p in peaks]}, sum "
          f"{sum(peaks) / 2**30:.3f}; one process {one_peak / 2**30:.3f}; "
          f"a rank's parameter slices {r0['local_bytes'] / 2**30:.3f} of "
          f"{one['local_bytes'] / 2**30:.3f}, one gathered group "
          f"{r0['gathered_group_bytes'] / 2**30:.3f}; bound "
          f"{bound / 2**30:.3f}")
    print(f"[{tag}] {what}: seconds of the run (spawned rank's fingerprint "
          f"and train(), set-up included): rank 0 {r0['rank_s']:.1f}, one "
          f"process {one['rank_s']:.1f}")
    print(f"[{tag}] {what}: rank 0's collectives a step: "
          f"{r0['collectives'] / steps:.0f} in "
          f"{r0['collective_s'] / steps:.3f}s; by kind (calls, s, payload "
          f"MB): " + "; ".join(
              f"{k} {n:.0f} {sec:.3f} {b / 1e6:.1f}"
              for k, (n, sec, b) in sorted(kinds.items())))
    out.update(ranks=mesh_res, one=one, peaks=peaks, one_peak=one_peak,
               by_kind_per_step=kinds, step_ms=ms, one_step_ms=one_ms)
    return out


# ---------------------------------------------------------------------------
# phase 7x: MoE, SSM and hybrid stacks on the training mesh
# ---------------------------------------------------------------------------
# (tag, arch, mesh shape, depth: overrides of the published config) of
# the runs that train() for TRAIN_MESH_STEPS steps: stablelm-1.6b's dense
# path ([train-mesh]); mamba2-370m whole (48 layers: in_proj cut over
# model and gathered, the mixer replicated), hymba-1.5b at 4 of its 32
# layers (one group of its pattern: a global and three windowed hybrid
# layers; its 25 heads and 5 KV heads do not divide 2, so the attention
# block replicates over model while the mixer and the FFN are cut, and
# its vocab 32001 replicates the embedding), whisper-medium at 2 of its
# 24 encoder and 2 of its 24 decoder layers over its 1500 frames (TP in
# the encoder, the self- and the cross-attention; vocab 51865
# replicated), internvl2-2b at 2 of its 24 layers with its 256 visual
# tokens (vocab 92553 replicated). The runs of one shape share a spawn,
# and every run's one-process reference shares one (1, 1) spawn
TRAIN_MESH_RUNS = (
    ("train-mesh", "stablelm-1.6b", TRAIN_MESH_SHAPE,
     dict(n_layers=TRAIN_MESH_LAYERS)),
    ("train-mesh-x", "mamba2-370m", (2, 2), dict(n_layers=48)),
    ("train-mesh-x", "hymba-1.5b", (2, 2), dict(n_layers=4)),
    ("train-mesh-x", "whisper-medium", (2, 2),
     dict(n_layers=2, n_enc_layers=2)),
    ("train-mesh-x", "internvl2-2b", (2, 2), dict(n_layers=2)))
# the frames' and the visual embeddings' generator (extra_batch)
TRAIN_EXTRA_SEED = 7
# dbrx-132b at 1 of its 40 layers on (1, 2): expert parallelism, 8 whole
# experts a rank; step 0 only: one layer with the embedding and head is
# 4.49 G parameters, 18.0 GB in fp32, and fp32 moments beside the
# parameters and gradients would not fit on one card
DBRX_TRAIN = dict(shape=(1, 2), layers=1, batch=2, seq=64)
# step 0's gradients, leaf by leaf, as [train-mesh]'s (norm and
# projection over the leaf's norm + TRAIN_MESH_GRAD_FLOOR x the whole's).
# The mesh's reordered fp32 sums drift further the deeper the stack: on
# the CPU (reduced mamba2, (2, 2) against one process) 6.6e-7 at 2
# layers, 3.1e-6 at 8, 8.1e-6 at 24; on the card mamba2's 48 layers read
# 5.5e-5 (the mixer's norm_scale, whose projection cancels most). So the
# limit is 3.6x that reading, as [train-mesh]'s is of its own; a sum
# dropped or doubled over an axis reads ~0.5
TRAIN_MESH_X_GRAD_TOL = 2e-4
TRAIN_MESH_X_RTOL = {"loss": 1e-6, "grad_norm": 1e-5}
DBRX_TRAIN_RTOL = 1e-6              # the loss and the aux at step 0


def train_jobs_rank(mesh, jobs):
    """``train_mesh_rank`` for each job in turn on this rank (the runs
    of one mesh shape share a spawn)."""
    out = []
    for job in jobs:
        out.append(train_mesh_rank(mesh, job))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_routes(cfg, params, batch, mesh=None, specs=None) -> list:
    """Every ``moe_block`` call's routing (``models.moe.record_routes``:
    expert ids, kept mask, smallest top-k margin) in one forward without
    gradients, in one process or on this rank's slices and rows."""
    from repro_torch import runtime_context as rctx
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding as shd
    from repro_torch.models import moe
    with torch.no_grad(), moe.record_routes() as out:
        if mesh is None:
            train_loss(cfg, params, batch, remat=False)
        else:
            with rctx.use_mesh(mesh, meshlib.dp_axes(mesh),
                               split_rows=True):
                train_loss(cfg, params, batch, remat=False,
                           gather=shd.fsdp_gather(specs, mesh))
    return out


def dbrx_train_batch(cfg, seed: int) -> dict:
    from repro_torch.data.synthetic import CorpusConfig, SyntheticCorpus
    b = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=seed + 1)
                        ).sample_batch(DBRX_TRAIN["batch"],
                                       DBRX_TRAIN["seq"], step=0)
    return {k: torch.from_numpy(v).long().cuda() for k, v in b.items()}


def moe_train_rank(mesh, job):
    """One rank of ``[train-mesh-x]``'s dbrx run: its slice of the
    parent's whole tree (CUDA IPC; every reference to the shared tree is
    dropped once sliced), the routing of a forward without gradients,
    then step 0 of ``mesh_grads_fn`` (remat on): the loss, the aux, the
    peak memory and the collectives by kind over it, and on rank 0 the
    gradients' fingerprints (``tree_fingerprints``)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.train.step import mesh_grads_fn
    t_rank = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, seed = job["cfg"], job["seed"]
    compute = mesh_grads_fn(cfg, mesh, remat=True)
    local = shd.train_slices(job["params"], mesh, compute.specs)
    job.clear()
    gc.collect()
    torch.cuda.synchronize()
    local_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(local))
    batch = dbrx_train_batch(cfg, seed)
    batch = {k: v[shd.batch_rows(mesh, DBRX_TRAIN["batch"])]
             for k, v in batch.items()}
    routes = moe_routes(cfg, local, batch, mesh, compute.specs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh.reset_counts()
    t0 = time.monotonic()
    loss, metrics, grads = compute(local, batch)
    torch.cuda.synchronize()
    step_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    kinds = {k: list(v) for k, v in mesh.by_kind.items()}
    del local
    leaves = tree_fingerprints(grads, seed, mesh, compute.specs)
    del grads
    torch.cuda.empty_cache()
    work = obs_costs.train_step_work(
        cfg, mesh, tokens=batch["tokens"].numel())
    return dict(rank=mesh.rank, routes=routes, loss=float(loss),
                flops=work["flops"],
                aux=float(metrics["aux"]), leaves=leaves, step_s=step_s,
                peak_bytes=peak, local_bytes=local_bytes, by_kind=kinds,
                rank_s=time.monotonic() - t_rank)


def check_routes(tag: str, got: list, want: list) -> float:
    """A rank's routing against one process's, call by call (the same
    rows: dp 1): expert ids and kept mask identical; the smallest top-k
    margin."""
    require(len(got) == len(want), f"[{tag}] {len(got)} MoE calls, one "
            f"process made {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        require(torch.equal(a["ids"], b["ids"]),
                f"[{tag}] call {i}: expert ids differ from one process's "
                f"({int((a['ids'] != b['ids']).sum())} of "
                f"{a['ids'].numel()}; smallest top-k margin "
                f"{b['margin']:.3e}): a routing flip voids the gradient "
                f"comparison")
        require(torch.equal(a["kept"], b["kept"]),
                f"[{tag}] call {i}: the kept mask differs from one "
                f"process's")
    return min(r["margin"] for r in got)


def dbrx_train_mesh(seed: int) -> dict:
    """dbrx-132b (DBRX_TRAIN) step 0 in one process here, then on the
    (1, 2) mesh's gloo ranks on the same whole tree (CUDA IPC): routing
    identical, the loss and aux within DBRX_TRAIN_RTOL, the gradients
    leaf by leaf within TRAIN_MESH_X_GRAD_TOL; each rank's peak within
    its slice of one process's plus 1 GiB."""
    from repro_torch.train.step import grads_fn
    tag = "train-mesh-x] [dbrx-132b"
    cfg = dataclasses.replace(get_config("dbrx-132b"),
                              n_layers=DBRX_TRAIN["layers"])
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    base = torch.cuda.memory_allocated()   # what earlier phases still hold
    params = init_params(cfg, seed, device="cuda")
    batch = dbrx_train_batch(cfg, seed)
    one_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(params))
    want_routes = moe_routes(cfg, params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.monotonic()
    loss, metrics, grads = grads_fn(cfg, remat=True)(params, batch)
    torch.cuda.synchronize()
    one = dict(step_s=time.monotonic() - t1, loss=float(loss),
               aux=float(metrics["aux"]),
               flops=obs_costs.train_step_work(
                   cfg, tokens=batch["tokens"].numel())["flops"],
               peak_bytes=torch.cuda.max_memory_allocated() - base,
               leaves=tree_fingerprints(grads, seed))
    del grads, loss, metrics
    torch.cuda.empty_cache()
    drops = sum(int((~r["kept"]).sum()) for r in want_routes)
    print(f"[{tag}] 1 of 40 layers, published widths, {one_bytes / 1e9:.2f}"
          f" GB of fp32 parameters, batch {DBRX_TRAIN['batch']} x "
          f"{DBRX_TRAIN['seq']}, capacity factor {cfg.capacity_factor}: "
          f"one process step 0 in {one['step_s']:.2f}s, loss "
          f"{one['loss']:.9g}, aux {one['aux']:.9g}, peak "
          f"{one['peak_bytes'] / 2**30:.2f} GiB, {drops} of "
          f"{sum(r['kept'].numel() for r in want_routes)} assignments "
          f"dropped (init and one process {time.monotonic() - t0:.1f}s)")
    require(drops > 0, f"[{tag}] no assignment dropped at capacity factor "
            f"{cfg.capacity_factor}: the capacity path went untested")
    t1 = time.monotonic()
    res = spawn(moe_train_rank, DBRX_TRAIN["shape"], backend="gloo",
                args=(dict(cfg=cfg, seed=seed, params=params),),
                timeout_s=600.0)
    spawn_s = time.monotonic() - t1
    del params
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    label = "({},{})".format(*DBRX_TRAIN["shape"])
    margins = [check_routes(f"{tag}] [rank {r['rank']}", r["routes"],
                            want_routes) for r in res]
    print(f"[{tag}] {label} routing: every rank's expert ids and kept mask "
          f"of every call equal one process's; smallest top-k margin "
          f"{min(margins):.3e}")
    for r in res:
        for k in ("loss", "aux"):
            rel = abs(r[k] - one[k]) / abs(one[k])
            require(rel <= DBRX_TRAIN_RTOL, f"[{tag}] rank {r['rank']}'s "
                    f"{k} {r[k]!r} against one process's {one[k]!r}: rel "
                    f"{rel:.2e} > {DBRX_TRAIN_RTOL}")
    r0 = res[0]
    err = compare_fingerprints("train-mesh-x", r0["leaves"], one["leaves"],
                               TRAIN_MESH_X_GRAD_TOL, TRAIN_MESH_GRAD_FLOOR,
                               "dbrx-132b")
    peaks = [r["peak_bytes"] for r in res]
    bound = one["peak_bytes"] * r0["local_bytes"] / one_bytes + 2**30
    require(max(peaks) <= bound,
            f"[{tag}] a rank's peak {max(peaks) / 2**30:.2f} GiB is over "
            f"its slice of one process's {one['peak_bytes'] / 2**30:.2f} "
            f"GiB plus 1 GiB ({bound / 2**30:.2f})")
    kinds = r0["by_kind"]
    print(f"[{tag}] {label} gloo ranks on one card: losses "
          f"{[r['loss'] for r in res]} (one process {one['loss']!r}), aux "
          f"{[r['aux'] for r in res]} (one process {one['aux']!r}); step 0 "
          f"{[round(r['step_s'], 2) for r in res]}s; peak (GiB) "
          f"{[round(p / 2**30, 3) for p in peaks]} of one process's "
          f"{one['peak_bytes'] / 2**30:.3f}, a rank's slices "
          f"{r0['local_bytes'] / 1e9:.2f} of {one_bytes / 1e9:.2f} GB; "
          f"bound {bound / 2**30:.3f}; counted matmul TFLOP "
          f"(obs.costs.train_step_work) a rank {r0['flops'] / 1e12:.3f}, "
          f"one process {one['flops'] / 1e12:.3f}; rank 0's collectives "
          f"by kind "
          f"(calls, s, payload MB): " + "; ".join(
              f"{k} {n} {sec:.3f} {b / 1e6:.1f}"
              for k, (n, sec, b) in sorted(kinds.items())) +
          f"; spawn to join {spawn_s:.1f}s")
    return dict(one=dict(one, leaves=None), ranks=[dict(r, routes=None,
                                                        leaves=None)
                                                   for r in res],
                grad_err=err, min_margin=min(margins), drops=drops,
                peaks=peaks, bound=bound, spawn_s=spawn_s)


def train_mesh_phases(seed: int):
    """``[train-mesh]`` and ``[train-mesh-x]``: each run of
    TRAIN_MESH_RUNS on its mesh's gloo ranks sharing the card (the runs of
    one shape in one spawn), then every run's one-process reference on a
    (1, 1) mesh in one spawn (after the ranks have exited); each held to
    its reference by ``check_train_runs`` (step 0's gradients leaf by
    leaf, the losses and grad norms of TRAIN_MESH_STEPS steps, every
    rank's metrics rank 0's, each rank's peak within its slice of one
    process's plus one gathered group; the collectives a step by kind).
    Then dbrx-132b's step 0 at (1, 2) (``dbrx_train_mesh``). gloo copies
    every collective through host memory and the ranks time-share one
    card, so the step time says nothing of NVLink or NCCL. Returns the
    two phases' results."""
    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    jobs = [dict(cfg=dataclasses.replace(get_config(arch), **depth),
                 seed=seed, tag=tag)
            for tag, arch, _, depth in TRAIN_MESH_RUNS]
    ranks, secs = {}, {}
    for shape in dict.fromkeys(run[2] for run in TRAIN_MESH_RUNS):
        mine = [i for i, run in enumerate(TRAIN_MESH_RUNS)
                if run[2] == shape]
        t0 = time.monotonic()
        res = spawn(train_jobs_rank, shape, backend="gloo",
                    args=([jobs[i] for i in mine],), timeout_s=900.0)
        secs["({},{})".format(*shape)] = time.monotonic() - t0
        for j, i in enumerate(mine):
            ranks[i] = [r[j] for r in res]
    t0 = time.monotonic()
    refs = spawn(train_jobs_rank, (1, 1), backend="gloo", args=(jobs,),
                 timeout_s=900.0)[0]
    secs["(1,1)"] = time.monotonic() - t0
    out = {"train-mesh": {"layers": TRAIN_MESH_LAYERS}, "train-mesh-x": {}}
    for i, (tag, arch, shape, depth) in enumerate(TRAIN_MESH_RUNS):
        full = get_config(arch)
        what = (f"{arch}, {depth['n_layers']} of {full.n_layers} "
                + (f"decoder layers and {depth['n_enc_layers']} of "
                   f"{full.n_enc_layers} encoder layers over "
                   f"{full.enc_seq} frames"
                   if full.is_encdec else "layers")
                + (f" with {full.n_vis_tokens} visual tokens"
                   if full.n_vis_tokens else "")
                + ", full width")
        tol, rtol = ((TRAIN_MESH_GRAD_TOL, TRAIN_MESH_RTOL)
                     if tag == "train-mesh" else
                     (TRAIN_MESH_X_GRAD_TOL, TRAIN_MESH_X_RTOL))
        out[tag][arch] = check_train_runs(
            tag, what, "({},{})".format(*shape), ranks[i], refs[i], tol,
            rtol)
    print(f"[train-mesh] spawn to join (s), shared with [train-mesh-x]: " +
          ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    out["train-mesh"]["spawn_s"] = secs
    out["train-mesh"]["seconds"] = time.monotonic() - t_phase
    print(f"[train-mesh] phases' spawns {out['train-mesh']['seconds']:.1f}s")
    t0 = time.monotonic()
    out["train-mesh-x"]["dbrx-132b"] = dbrx_train_mesh(seed)
    out["train-mesh-x"]["seconds"] = time.monotonic() - t0
    print(f"[train-mesh-x] dbrx-132b {out['train-mesh-x']['seconds']:.1f}s;"
          f" both phases {time.monotonic() - t_phase:.1f}s")
    return out["train-mesh"], out["train-mesh-x"]


# ---------------------------------------------------------------------------
def summary(rows, launches, bw_name, hymba_attn_launches: int,
            moe_qmm_launches: int, moe_attn_launches: int,
            s3b_attn_launches: int, g2_attn_launches: int,
            sliced_attn_launches: int, hymba_mesh_attn_launches: int,
            dbrx_ep_qmm_launches: int):
    """One row per kernel for the JSON line: the representative shape of
    the main path (decode M=4 / prefill M=512 through the 2048 x 5632 MLP
    projection, fp32; the mixed ragged chunk over fp32 pages; the
    lm_head's inlier stream); ``launches`` per kernel from the run of the
    path it serves (the serving kernels: the graphed run (b)). Then the
    attention rows at hymba-1.5b's shapes (G = 5, window 1024; fp32 and
    bf16 pages), with the launches of the hybrid phase's graphed run, the
    attention rows and the decode qmm rows at dbrx-132b's shapes, with
    the launches of the MoE phase's graphed run, and the attention rows at
    stablelm-3b's and gemma2-2b's shapes (fp32, bf16 and int8 pages), with
    the launches of each one's graphed run in the attn-hd phase; and the
    attention rows over a data rank's page slice (D = 2, the slower
    slice's time, the merge's beside it), with the launches of rank 0 of
    the mesh phase's (2, 2) run (at hymba-1.5b's shapes: of rank 0 of
    ``[mesh-x]``'s (2, 2) run, every KV head on each model rank). The
    dbrx expert rows also carry ``ep_rank_launches``: rank 0's decode qmm
    launches on ``[mesh-x]``'s (2, 2) expert-parallel mesh."""
    pick = {"qmm_decode": ("M=4 K=2048 N=5632", "float32"),
            "qmm_colstrip": ("M=512 K=2048 N=5632", "float32"),
            "ragged_paged_attention": ("chunk S=128", "float32"),
            "unpack3b": ("n=143864832", "uint8->int32")}
    meta = {
        "qmm_decode": ("src/repro_torch/csrc/qmm.cu",
                       "src/repro/kernels/qmm.py:122"),
        "qmm_colstrip": ("src/repro_torch/csrc/qmm.cu",
                         "src/repro/kernels/qmm.py:224"),
        "ragged_paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:180"),
        "unpack3b": ("src/repro_torch/csrc/unpack3b.cu",
                     "src/repro/kernels/unpack3b.py:30"),
    }
    out = []
    for name, (shape, dtype) in pick.items():
        row = next(r for r in rows if r["kernel"] == name
                   and r["shape"] == shape and r["dtype"] == dtype)
        src, rep = meta[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": launches[name],
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "host_ms": row["host_ms"],
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"],
                    "shape": f"{shape} {dtype}", "peaks": bw_name})
    src, rep = meta["ragged_paged_attention"]
    attn_launches = {HYMBA_DECODE: hymba_attn_launches,
                     HYMBA_CHUNK: hymba_attn_launches,
                     DBRX_DECODE: moe_attn_launches,
                     DBRX_CHUNK: moe_attn_launches,
                     S3B_DECODE: s3b_attn_launches,
                     S3B_CHUNK: s3b_attn_launches,
                     G2_DECODE: g2_attn_launches,
                     G2_CHUNK: g2_attn_launches,
                     SLICED_DECODE: sliced_attn_launches,
                     SLICED_CHUNK: sliced_attn_launches,
                     SLICED_HYMBA: hymba_mesh_attn_launches}
    for row in rows:
        if row["shape"] in attn_launches:
            out.append({"name": f"ragged_paged_attention "
                                f"[{row['shape']} {row['dtype']}]",
                        "route": "cuda", "source": src, "replaces": rep,
                        "launches": attn_launches[row["shape"]],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "host_ms": row["host_ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        "shape": f"{row['shape']} {row['dtype']}",
                        "peaks": bw_name,
                        **({"merge_ms": row["merge_ms"]}
                           if "merge_ms" in row else {})})
    src, rep = meta["qmm_decode"]
    for row in rows:
        if row["shape"].endswith("dbrx expert"):
            out.append({"name": f"qmm_decode [{row['shape']} "
                                f"{row['dtype']}]",
                        "route": "cuda", "source": src, "replaces": rep,
                        "launches": moe_qmm_launches,
                        "ep_rank_launches": dbrx_ep_qmm_launches,
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "host_ms": row["host_ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        "shape": f"{row['shape']} {row['dtype']}",
                        "peaks": bw_name})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "chip_smoke.json",
                    help="where the full JSON report goes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    bw, fl, tc, peak_name = peaks(name)
    peak = (bw, fl, tc)
    print(f"[device] {name}; nvidia-smi: {smi}; peaks ({peak_name}): "
          f"{bw / 1e12:.2f} TB/s, {fl / 1e12:.0f} TFLOP/s fp32, "
          f"{tc / 1e12:.0f} TFLOP/s TF32 tensor cores")

    t0 = time.monotonic()
    build.library()
    print(f"[build] {build.build_info['path']} in "
          f"{time.monotonic() - t0:.1f}s")
    print(build.build_info["log"])

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    timer = Timer()
    rows = []
    check_qmm(timer, peak, gen, rows)
    check_patterns(timer, peak, gen, rows)
    empty = check_empty_launch(timer)
    check_attention(timer, peak, gen, rows)
    check_sliced_attention(timer, peak, gen, rows)
    check_expert_qmm(timer, peak, gen, rows)
    del timer

    cfg = get_config("stablelm-1.6b")
    t0 = time.monotonic()
    params = init_params(cfg, args.seed, device="cuda")
    qparams = quantize_for_serving(params, QMCConfig(
        rho=0.3, granularity="subtile"), min_dim=64)
    del params
    torch.cuda.synchronize()
    print(f"[serve] stablelm-1.6b full width: init + QMC PTQ on the card in "
          f"{time.monotonic() - t0:.1f}s")
    served, greedy_tokens = serve_phase(cfg, qparams, args.seed)
    meshed = mesh_phase(cfg, qparams, args.seed, greedy_tokens)
    extended = serve_x_phase(cfg, qparams, args.seed, greedy_tokens,
                             served["runs"]["b graphed"]["pool_bytes"])
    observed = obs_phase(cfg, qparams, args.seed, greedy_tokens,
                         served["idle"])
    kept, contig = {}, {}
    hybrid = hybrid_phase(args.seed, kept)
    moe = moe_phase(args.seed, rows, kept)
    families = {arch: family_arch(arch, args.seed, contig)
                for arch in FAMILY_CONTIG}
    family_meshed = family_mesh_phase(args.seed, kept, contig)
    kept.clear()
    contig.clear()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    families["legacy"] = legacy_vs_paged(cfg, qparams, args.seed,
                                         greedy_tokens)
    dried = dryrun_phase()
    attn_hd = attn_hd_phase(args.seed)
    stepped = whole_step(cfg, qparams, args.seed)

    timer = Timer()
    check_unpack3b(timer, peak, gen, rows)
    del timer
    build.reset_launches()
    kops.reset_path_counts()
    quick = ptq_quickstart(cfg, args.seed)
    read = reram_read_path(qparams)
    torch.cuda.synchronize()
    ptq_launches = dict(build.launches)
    ptq_paths = dict(kops.path_counts)
    print(f"[ptq] kernel launches {ptq_launches}; qmm paths {ptq_paths}")
    for k in ("qmm_colstrip", "unpack3b"):
        require(ptq_launches[k] > 0, f"kernel {k} never launched on the "
                f"PTQ path")
    require(ptq_paths["ref"] == 0, "qmm took the plain 'ref' path on the "
            "PTQ path")
    fig4 = fig4_rows()
    del qparams
    torch.cuda.empty_cache()
    trained = train_phase(cfg, args.seed)
    train_meshed, train_meshed_x = train_mesh_phases(args.seed)

    launches = dict(served["runs"]["b graphed"]["launches"],
                    unpack3b=ptq_launches["unpack3b"])
    hd_launches = {arch: attn_hd[arch]["b graphed"]["launches"][
        "ragged_paged_attention"] for arch in attn_hd}
    kernels = summary(rows, launches, peak_name, hybrid["hymba-1.5b"][
        "b graphed"]["launches"]["ragged_paged_attention"],
        moe["b graphed"]["launches"]["qmm_decode"],
        moe["b graphed"]["launches"]["ragged_paged_attention"],
        hd_launches["stablelm-3b"], hd_launches["gemma2-2b"],
        meshed["(2,2)"]["launches"]["ragged_paged_attention"],
        family_meshed["hymba-1.5b"]["(2,2)"]["launches"][
            "ragged_paged_attention"],
        family_meshed["dbrx-132b"]["(2,2)"]["launches"]["qmm_decode"])
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(
        device=name, nvidia_smi=smi, rows=rows, empty_launch=empty,
        serve=served, serve_x=extended, obs=observed, hybrid=hybrid,
        mesh=meshed, moe=moe, mesh_families=family_meshed,
        families=families, dryrun=dried, attn_hd=attn_hd,
        step=stepped,
        train=trained, train_mesh=train_meshed,
        train_mesh_x=train_meshed_x,
        ptq=dict(quickstart=quick, read_path=read, launches=ptq_launches,
                 qmm_paths=ptq_paths, fig4=fig4),
        kernels=kernels, seconds=time.monotonic() - t_start), indent=1))
    print(f"[done] {time.monotonic() - t_start:.1f}s; details in {args.out}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
