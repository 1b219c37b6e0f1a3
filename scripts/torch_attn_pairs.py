"""Device time of the ragged paged-attention kernel in two (or more)
checkouts of the PyTorch port, alternated.

Each tree is a directory holding ``src/`` and ``chip_smoke.py`` (a
checkout, or ``git archive`` of one unpacked). The trees run in the order
A B B A per pair (A B C C B A for three), each in a fresh process that
imports that tree's ``repro_torch`` and ``chip_smoke`` and times, with
``chip_smoke.Timer`` (median of 20 CUDA-event runs, L2 flushed), the
kernel at the chip_smoke attention shapes every tree takes: the serve
phase's decode, long decode and chunk lanes (hd 64, 32 KV heads) over
fp32, int8 and bf16 pages, hymba-1.5b's (G = 5, window 1024) over every
page kind, dbrx-132b's (hd 128, G = 6) over fp32 pages, stablelm-3b's
(hd 80) and
gemma2-2b's (hd 256, G = 2, window 4096, softcap 50) over every page
kind, and each of two page slices (D = 2, pages numbered as the pool
hands them out, fp32 pages) at the serve phase's decode and chunk lanes
and hymba-1.5b's decode (chip_smoke's rows 3d and 3d-h). One line of JSON
per process, then a table of ms per shape and tree.

    python scripts/torch_attn_pairs.py --trees build/parent build/change
    python scripts/torch_attn_pairs.py --trees ... --only "hymba|dbrx"

Needs a CUDA card; the trees build their kernels first, in parallel.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

DECODE = [(69, 1), (192, 1), (239, 1), (0, 0)]
LONG = [(4095, 1), (3000, 1), (1500, 1), (511, 1)]
CHUNK = [(0, 128), (64, 100), (200, 1), (0, 0)]
PAGES = ("float32", "int8", "bfloat16")
# (label, lanes, KV heads, G, page dtype, window, hd[, softcap])
CASES = [(f"{name} {dt}", lanes, 32, 1, dt, None, 64)
         for name, lanes in (("decode", DECODE), ("decode<=4096", LONG),
                             ("chunk S=128", CHUNK))
         for dt in PAGES] + [
    case for dt in PAGES for case in (
        (f"hymba decode {dt}", [(2047, 1), (1800, 1), (1030, 1), (0, 0)],
         5, 5, dt, 1024, 64),
        (f"hymba chunk {dt}", [(1100, 128), (1500, 100), (2047, 1), (0, 0)],
         5, 5, dt, 1024, 64))] + [
    ("dbrx decode", [(200, 1), (150, 1), (31, 1), (0, 0)], 8, 6,
     "float32", None, 128),
    ("dbrx chunk", CHUNK, 8, 6, "float32", None, 128)] + [
    case for dt in PAGES for case in (
        (f"s3b decode {dt}", DECODE, 32, 1, dt, None, 80),
        (f"s3b chunk {dt}", CHUNK, 32, 1, dt, None, 80),
        (f"g2 decode {dt}", [(8191, 1), (5000, 1), (4100, 1), (0, 0)], 4,
         2, dt, 4096, 256, 50.0),
        (f"g2 chunk {dt}", [(4200, 128), (6000, 100), (8191, 1), (0, 0)],
         4, 2, dt, 4096, 256, 50.0))]
# over a data rank's page slice: (label, lanes, KV heads, G, window)
SLICED = [("sliced decode", DECODE, 32, 1, None),
          ("sliced chunk", CHUNK, 32, 1, None),
          ("sliced hymba decode", [(2047, 1), (1800, 1), (1030, 1), (0, 0)],
           5, 5, 1024)]


def one(tree: Path, seed: int) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import (
        ragged_paged_attention_call)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    timer = cs.Timer()
    ms = {}
    for label, lanes, n_kv, g, dt, window, hd, *cap in CASES:
        q, cache, qs, kl, _, _ = cs.make_attn_case(
            lanes, n_kv=n_kv, g=g, hd=hd, page=16, quantized=dt == "int8",
            bf16=dt == "bfloat16", gen=gen)
        kw = dict(n_kv=n_kv, head_dim=hd, window=window,
                  attn_softcap=cap[0] if cap else None)
        ms[label] = timer(lambda: ragged_paged_attention_call(
            q, cache, qs, kl, **kw))
    for label, lanes, n_kv, g, window in SLICED:
        q, cache, qs, kl, _, _ = cs.make_attn_case(
            lanes, n_kv=n_kv, g=g, hd=64, page=16, quantized=False, gen=gen)
        cs.in_order(cache)
        n = cache["k_pages"].shape[0]
        for i, (first, pages) in enumerate(((0, n // 2),
                                            (n // 2, n - n // 2))):
            local = {k: (v[first:first + pages].contiguous()
                         if k.endswith("_pages") else v)
                     for k, v in cache.items()}
            kw = dict(n_kv=n_kv, head_dim=64, window=window,
                      page_slice=(first, pages))
            ms[f"{label} {i}"] = timer(lambda: ragged_paged_attention_call(
                q, local, qs, kl, **kw))
    return {"tree": str(tree), "ms": ms,
            "device": torch.cuda.get_device_name(0)}


def _child(tree: Path, *args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    return subprocess.Popen([sys.executable, __file__, "--tree", str(tree),
                             *args], env=env, stdout=subprocess.PIPE,
                            text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=Path)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", metavar="REGEX",
                    help="time only the shapes whose label matches")
    a = ap.parse_args()
    if a.only:
        import re
        CASES[:] = [c for c in CASES if re.search(a.only, c[0])]
        SLICED[:] = [c for c in SLICED if re.search(a.only, c[0])]
    if a.tree is not None:                     # one child process
        if a.build_only:
            sys.path[:0] = [str(a.tree / "src")]
            from repro_torch.kernels import build
            build.library()
            return 0
        print(json.dumps(one(a.tree, a.seed)))
        return 0
    trees = [t.resolve() for t in a.trees]
    procs = [_child(t, "--build-only") for t in trees]
    if any(p.wait() != 0 for p in procs):
        print("a tree's kernels did not build", file=sys.stderr)
        return 1
    results = []
    for _ in range(a.pairs):
        for t in trees + trees[::-1]:
            t0 = time.monotonic()
            p = _child(t, "--seed", str(a.seed),
                       *(["--only", a.only] if a.only else []))
            out, _ = p.communicate()
            if p.returncode != 0:
                print(f"{t} failed", file=sys.stderr)
                return 1
            r = json.loads(out.strip().splitlines()[-1])
            r["process_s"] = time.monotonic() - t0
            print(json.dumps(r), flush=True)
            results.append(r)
    labels = [c[0] for c in CASES] + [f"{c[0]} {i}" for c in SLICED
                                       for i in (0, 1)]
    for label in labels:
        cells = []
        for t in trees:
            xs = [r["ms"][label] for r in results if r["tree"] == str(t)]
            cells.append(f"{t.name} " + ", ".join(f"{x:.4f}" for x in xs))
        print(f"{label:24s} " + " | ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
