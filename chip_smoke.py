#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):

  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — nvcc builds the kernels from ``src/repro_torch/csrc``;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the main path's shapes, with its time, the plain
                version's, a library call's (yardstick only) and its bound;
  4. serve    — full-width stablelm-1.6b (random weights from a seed, QMC
                PTQ on the card), 8 requests through the paged engine with
                the qmm streams and paged attention; every kernel of the
                path must have launched and the qmm "ref" path must not;
  5. step     — one mixed ragged step at full width through the kernels
                and through the plain versions, logits compared.

The line before the last is a JSON object with one row per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits nonzero before printing any result.
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
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.qconfig import QMCConfig  # noqa: E402
from repro_torch.core.qtensor import (dequantize_qtensor,  # noqa: E402
                                      quantize_qtensor)
from repro_torch.core.serving_quant import quantize_for_serving  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    ragged_paged_attention_call)
from repro_torch.kernels.qmm import qmm_colstrip, qmm_decode  # noqa: E402
from repro_torch.kernels.ref import (qmm_ref,  # noqa: E402
                                     ragged_paged_attention_ref)
from repro_torch.models.attention import paged_cache_read  # noqa: E402
from repro_torch.models.kvcache import quantize_kv  # noqa: E402
from repro_torch.models.model import forward, init_params  # noqa: E402
from repro_torch.serve import steps as serve_steps  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged_kv import PagedKVPool  # noqa: E402
from repro_torch.serve.sampling import DEAD_TOKEN  # noqa: E402

QMM_SHAPES = [(2048, 2048), (2048, 5632), (5632, 2048), (2048, 100352)]
# (memory bytes/s, fp32 FLOP/s outside the tensor cores), NVIDIA data
# sheets; the first name fragment found in the card's name wins
PEAKS = [("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100", 3.35e12, 67e12)]
TOL_QMM = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # x max|y|
ATT_ATOL, ATT_RTOL = 1e-5, 1e-4


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def peaks(name: str):
    for frag, bw, fl in PEAKS:
        if frag in name:
            return bw, fl, frag
    print(f"[device] {name!r} is not in the peak table; bounds use the "
          f"H100 SXM figures")
    return PEAKS[-1][1], PEAKS[-1][2], "H100"


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


def check_qmm(timer, bw, fl, gen, rows):
    for k, n in QMM_SHAPES:
        qt = quantize_qtensor(make_weight(k, n, gen), QMCConfig(
            rho=0.3, granularity="subtile"))
        w_dense = dequantize_qtensor(qt, torch.float32)
        code_bytes = k * n + qt.stream_pos.numel() * 4 + qt.is_out.numel() \
            + 2 * n * 4
        cases = [("qmm_decode", m, qmm_decode, 8) for m in (1, 4, 7)] + \
                [("qmm_colstrip", m, qmm_colstrip, 128) for m in (128, 512)]
        for name, m, kernel, mult in cases:
            for dtype in (torch.float32, torch.bfloat16):
                pad = -(-m // mult) * mult
                x = torch.zeros((pad, k), dtype=dtype, device="cuda")
                x[:m] = torch.randn((m, k), generator=gen,
                                    device="cuda").to(dtype)
                y = kernel(x, qt)[:m].float()
                y_ref = qmm_ref(x, qt)[:m].float()
                torch.cuda.synchronize()
                err = (y - y_ref).abs().max().item()
                scale = y_ref.abs().max().item()
                tol = TOL_QMM[dtype] * scale
                require(err <= tol, f"{name} M={m} K={k} N={n} {dtype}: max "
                        f"abs err {err:.3e} > {tol:.3e}")
                ms = timer(lambda: kernel(x, qt))
                host_ms = timer.host(lambda: kernel(x, qt))
                plain_ms = timer(lambda: qmm_ref(x, qt))
                xd = x.to(torch.float32)
                lib_ms = timer(lambda: torch.matmul(xd, w_dense))
                xb = x.element_size()
                b_ms, b_by = bound(m * k * xb + code_bytes + m * n * xb,
                                   2.0 * m * k * n, bw, fl)
                rows.append(dict(kernel=name, shape=f"M={m} K={k} N={n}",
                                 dtype=str(dtype).replace("torch.", ""),
                                 max_abs_err=err, tol=tol, ms=ms,
                                 host_ms=host_ms, plain_ms=plain_ms,
                                 library_ms=lib_ms,
                                 bound_ms=b_ms, bound_by=b_by))
                print(f"[kernels] {name:13s} M={m:3d} K={k:5d} N={n:6d} "
                      f"{rows[-1]['dtype']:8s} err={err:.2e} (tol "
                      f"{tol:.1e}) ms={ms:.4f} host={host_ms:.4f} "
                      f"plain={plain_ms:.4f} "
                      f"lib={lib_ms:.4f} bound={b_ms:.4f} ({b_by})")
        del qt, w_dense


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


def check_attention(timer, bw, fl, gen, rows):
    hd, page, b = 64, 16, 4
    decode = [(69, 1), (192, 1), (239, 1), (0, 0)]
    chunk = [(0, 128), (64, 100), (200, 1), (0, 0)]
    cases = [("decode S=1", decode, 32, 1, False, None, None),
             ("decode S=1", decode, 32, 1, True, None, None),
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
              f"sdpa={lib_ms:.4f} "
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
    for k, v in launches.items():
        require(v > 0, f"kernel {k} never launched on the serving path")
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
def summary(rows, launches, bw_name):
    """One row per kernel for the JSON line: the representative shape of
    the main path (decode M=4 / prefill M=512 through the 2048 x 5632 MLP
    projection, fp32; the mixed ragged chunk over fp32 pages)."""
    pick = {"qmm_decode": ("M=4 K=2048 N=5632", "float32"),
            "qmm_colstrip": ("M=512 K=2048 N=5632", "float32"),
            "ragged_paged_attention": ("chunk S=128", "float32")}
    meta = {
        "qmm_decode": ("src/repro_torch/csrc/qmm.cu",
                       "src/repro/kernels/qmm.py:122"),
        "qmm_colstrip": ("src/repro_torch/csrc/qmm.cu",
                         "src/repro/kernels/qmm.py:224"),
        "ragged_paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:180"),
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
    bw, fl, peak_name = peaks(name)
    print(f"[device] {name}; nvidia-smi: {smi}; peaks ({peak_name}): "
          f"{bw / 1e12:.2f} TB/s, {fl / 1e12:.0f} TFLOP/s fp32")

    t0 = time.monotonic()
    build.library()
    print(f"[build] {build.build_info['path']} in "
          f"{time.monotonic() - t0:.1f}s")
    print(build.build_info["log"])

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    timer = Timer()
    rows = []
    check_qmm(timer, bw, fl, gen, rows)
    check_attention(timer, bw, fl, gen, rows)
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

    kernels = summary(rows, served["launches"], peak_name)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(
        device=name, nvidia_smi=smi, rows=rows, serve=served, step=stepped,
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
