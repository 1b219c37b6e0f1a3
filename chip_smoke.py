#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):

  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — nvcc builds the kernels from ``src/repro_torch/csrc``;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the main path's shapes, with its time, the plain
                version's, a library call's (yardstick only; the
                kernel/library ratio is what compares across cards) and
                its bound; the decode-width qmm also at M=64 (eight M
                tiles) and both qmm kernels on all-inlier, all-outlier
                and checkerboard weights, attention also on decode lanes
                at kv_len up to 4096 (split over spans); and the time of
                an empty kernel launch, the floor under any one-launch
                call;
  4. serve    — full-width stablelm-1.6b (random weights from a seed, QMC
                PTQ on the card), 8 requests through the paged engine with
                the qmm streams and paged attention; every kernel of the
                path must have launched and the qmm "ref" path must not;
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
                the fig4 memory co-design rows for hymba-1.5b.

The line before the last is a JSON object with one row per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or copied somewhere without ``src/repro_torch`` beside it, the script
exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

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
from repro_torch.core.serving_quant import quantize_for_serving  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    ragged_paged_attention_call)
from repro_torch.kernels.qmm import (empty_launch,  # noqa: E402
                                     qmm_colstrip, qmm_decode)
from repro_torch.kernels.ref import (qmm_ref,  # noqa: E402
                                     ragged_paged_attention_ref,
                                     unpack3b_ref)
from repro_torch.kernels.unpack3b import unpack3b_call  # noqa: E402
from repro_torch.models.attention import paged_cache_read  # noqa: E402
from repro_torch.models.kvcache import quantize_kv  # noqa: E402
from repro_torch.models.model import forward, init_params  # noqa: E402
from repro_torch.serve import steps as serve_steps  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged_kv import PagedKVPool  # noqa: E402
from repro_torch.serve.sampling import DEAD_TOKEN  # noqa: E402

QMM_SHAPES = [(2048, 2048), (2048, 5632), (5632, 2048), (2048, 100352)]
SERVE_KERNELS = ("qmm_decode", "qmm_colstrip", "ragged_paged_attention")
# codes: the benchmarks/kernels.py size; the inlier stream of one
# 2048 x 5632 projection and of the 2048 x 100352 head at rho 0.3; a
# multiple of 8 that is not one of 32; and one that is not a multiple of 8
# (the kernel's partial last quad)
UNPACK_SIZES = [65_536, 8_074_240, 143_864_832, 65_544, 65_541]
PTQ_METHODS = [("fp16", "fp16", False), ("rtn4", "rtn4", False),
               ("mx4", "mx4", False), ("qmc", "qmc", False),
               ("qmc+ReRAM noise", "qmc", True), ("qtensor", "qtensor", False)]
# (memory bytes/s, fp32 FLOP/s outside the tensor cores, dense TF32
# tensor-core FLOP/s), NVIDIA data sheets; the first name fragment found in
# the card's name wins
PEAKS = [("H100 PCIe", 2.0e12, 51e12, 378e12),
         ("H100 NVL", 3.9e12, 60e12, 417.5e12),
         ("H100", 3.35e12, 67e12, 495e12)]
TOL_QMM = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # x max|y|
ATT_ATOL, ATT_RTOL = 1e-5, 1e-4


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def peaks(name: str):
    for frag, bw, fl, tc in PEAKS:
        if frag in name:
            return bw, fl, tc, frag
    print(f"[device] {name!r} is not in the peak table; bounds use the "
          f"H100 SXM figures")
    return (*PEAKS[-1][1:], "H100")


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
    xb = x.element_size()
    code_bytes = k * n + qt.stream_pos.numel() * 4 + qt.is_out.numel() \
        + 2 * n * 4
    nbytes = m * k * xb + code_bytes + m * n * xb
    flops = 2.0 * m * k * n
    b32_ms, _ = bound(nbytes, flops, bw, fl)
    products = 2 if dtype == torch.float32 else 1
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
                   poison=1e3):
    """A ragged case on the card: per-lane (q_start, n_new), shuffled page
    ids, the null page poisoned."""
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
        cache.update(k_pages=kf.reshape(n_pages, page, -1).contiguous(),
                     v_pages=vf.reshape(n_pages, page, -1).contiguous())
    s = max(1, int(n_new.max()))
    q = torch.randn((len(lanes), s, n_kv * g, hd), generator=gen,
                    device="cuda")
    return q, cache, q_start, kv_len, n_new, live


def attn_cost(q, cache, q_start, n_new, live, *, n_kv, hd, page, window):
    """Bytes each input/output moves once, and the QK + PV FLOPs of the
    live (unmasked) score entries of this data."""
    b, s, h, _ = q.shape
    kv_el = cache["k_pages"].element_size()
    nbytes = 2 * q.numel() * 4 + 2 * b * s * h * 4          # q, o, m, l
    nbytes += 2 * sum(live) * page * n_kv * hd * kv_el
    if "k_scale_pages" in cache:
        nbytes += 2 * sum(live) * page * n_kv * 2
    nbytes += cache["block_tbl"].numel() * 4 + 2 * b * 4
    flops = 0
    for qs, nn in zip(q_start.tolist(), n_new.tolist()):
        for t in range(nn):
            vis = qs + t + 1
            if window:
                vis = min(vis, window)
            flops += 4 * hd * h * vis
    return nbytes, flops


def check_attention(timer, peak, gen, rows):
    bw, fl, _ = peak
    hd, page, b = 64, 16, 4
    decode = [(69, 1), (192, 1), (239, 1), (0, 0)]
    # StableLM-2-1.6B's published context is 4096 tokens
    long_ctx = [(4095, 1), (3000, 1), (1500, 1), (511, 1)]
    chunk = [(0, 128), (64, 100), (200, 1), (0, 0)]
    cases = [("decode S=1", decode, 32, 1, False, None, None),
             ("decode S=1", decode, 32, 1, True, None, None),
             ("decode S=1 kv_len<=4096", long_ctx, 32, 1, False, None,
              None),
             ("decode S=1 kv_len<=4096", long_ctx, 32, 1, True, None, None),
             ("chunk S=128", chunk, 32, 1, False, None, None),
             ("chunk S=128", chunk, 32, 1, True, None, None),
             ("chunk S=128 window+softcap G=2", chunk, 16, 2, False, 32,
              50.0)]
    for label, lanes, n_kv, g, quant, window, cap in cases:
        q, cache, qs, kl, n_new, live = make_attn_case(
            lanes, n_kv=n_kv, g=g, hd=hd, page=page, quantized=quant,
            gen=gen)
        kw = dict(n_kv=n_kv, head_dim=hd, window=window, attn_softcap=cap)
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
                & (pk[None, None, :] < kl[:, None, None]))[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = timer(lambda: sdpa(qh, kh, vh, attn_mask=mask))
        nbytes, flops = attn_cost(q, cache, qs, n_new, live, n_kv=n_kv,
                                  hd=hd, page=page, window=window)
        b_ms, b_by = bound(nbytes, flops, bw, fl)
        dt = "int8" if quant else "float32"
        rows.append(dict(kernel="ragged_paged_attention", shape=label,
                         dtype=dt, max_abs_err=err, ms=ms,
                         host_ms=host_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"[kernels] attention {label:31s} {dt:7s} err={err:.2e} "
              f"ms={ms:.4f} host={host_ms:.4f} plain={plain_ms:.4f} "
              f"sdpa={lib_ms:.4f} ratio={ms / lib_ms:.3f} "
              f"bound={b_ms:.4f} ({b_by})")


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


def serve(cfg, qparams, seed: int):
    eng = ServeEngine(cfg, qparams, slots=4, max_len=256,
                      paged_attention=True, weight_plan=False,
                      device="cuda")
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
                f"request {r.uid} emitted {len(r.out_tokens)} of "
                f"{r.max_new_tokens} tokens")
        require(DEAD_TOKEN not in r.out_tokens and all(
            0 <= t < cfg.vocab for t in r.out_tokens),
            f"request {r.uid} emitted an impossible token")
    for k in SERVE_KERNELS:
        require(launches[k] > 0, f"kernel {k} never launched on the "
                f"serving path")
    require(paths["ref"] == 0, f"qmm took the plain 'ref' path "
            f"{paths['ref']} times on the serving path")
    ttft = float(np.percentile(s.ttft_s, 50)) * 1e3
    print(f"[serve] {s.tokens_out} tokens, {s.rounds} rounds "
          f"({s.prefill_chunks} prefill chunks, {s.decode_steps} decode "
          f"rounds), {s.wall_s:.3f}s, {s.tokens_per_s:.1f} tok/s, TTFT "
          f"p50 {ttft:.1f} ms, preemptions {s.preemptions}")
    round_ms = np.asarray(s.step_seconds) * 1e3
    print(f"[serve] round wall ms: p50 {np.median(round_ms):.1f}, max "
          f"{round_ms.max():.1f}")
    print(f"[serve] kernel launches {launches}; qmm paths {paths}")
    return dict(tokens=s.tokens_out, rounds=s.rounds, wall_s=s.wall_s,
                tokens_per_s=s.tokens_per_s, ttft_p50_ms=ttft,
                round_ms_p50=float(np.median(round_ms)),
                round_ms_max=float(round_ms.max()),
                launches=launches, qmm_paths=paths)


def whole_step(cfg, qparams, seed: int):
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
    arena_plain = {k: {"attn": {n: t.clone() for n, t in v["attn"].items()}}
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
        print(f"[step] {label} (C={c}, n_new={n_new.tolist()}): "
              f"max|logits diff| {diff:.3e} vs 1e-3 * max|logits| "
              f"{1e-3 * scale:.3e}")
        out[label] = dict(max_abs_diff=diff, max_abs_logit=scale)
        start = start + n_new
    return out


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
    At most two full-width trees (the dense one and one quantized) live
    on the card at a time."""
    params = init_params(cfg, seed, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(2, 256)), device="cuda")
    ref = forward(cfg, params, toks)
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
                           min_dim=64)
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
          f"layers")
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
def summary(rows, launches, bw_name):
    """One row per kernel for the JSON line: the representative shape of
    the main path (decode M=4 / prefill M=512 through the 2048 x 5632 MLP
    projection, fp32; the mixed ragged chunk over fp32 pages; the
    lm_head's inlier stream); ``launches`` per kernel from the run of the
    path it serves."""
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
    served = serve(cfg, qparams, args.seed)
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

    launches = dict(served["launches"], unpack3b=ptq_launches["unpack3b"])
    kernels = summary(rows, launches, peak_name)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(
        device=name, nvidia_smi=smi, rows=rows, empty_launch=empty,
        serve=served, step=stepped,
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
