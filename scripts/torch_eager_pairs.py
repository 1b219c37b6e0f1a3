"""Eager serve throughput of two checkouts of the PyTorch port, alternated.

Each tree is a directory holding ``src/`` and ``chip_smoke.py`` (a
checkout, or ``git archive`` of one unpacked). For every arch and pair
the trees run in the order A B B A, each in a fresh process that imports
that tree's ``repro_torch`` and ``chip_smoke``: the model at full width
(``chip_smoke.ssm_model``, random weights from the seed, QMC PTQ at rho
0.3), chip_smoke's 8 requests on the eager engine (4 slots, fp32 pages,
max_len 256), one warm-up run and ``--runs`` measured runs. One line of
JSON per process, then a table of tokens/s per tree.

    python scripts/torch_eager_pairs.py --trees build/parent build/change \\
        --archs mamba2-370m hymba-1.5b --pairs 2

Needs a CUDA card; both trees build their kernels first, in parallel.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def one(tree: Path, arch: str, seed: int, runs: int) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    build.library()
    cfg, qparams = cs.ssm_model(arch, seed)
    eng = cs.serve_engine(cfg, qparams, cuda_graphs=False)
    eng.run(cs.make_requests(cfg, 8, seed))
    torch.cuda.synchronize()
    tps = []
    for _ in range(runs):
        eng.run(cs.make_requests(cfg, 8, seed))
        torch.cuda.synchronize()
        tps.append(eng.stats.tokens_per_s)
    return {"tree": str(tree), "arch": arch, "tokens_per_s": tps,
            "rounds": eng.stats.rounds}


def _child(tree: Path, *args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    return subprocess.Popen([sys.executable, __file__, "--tree", str(tree),
                             *args], env=env, stdout=subprocess.PIPE,
                            text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, type=Path)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--archs", nargs="+",
                    default=["mamba2-370m", "hymba-1.5b"])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    if a.tree is not None:                     # one child process
        if a.build_only:
            sys.path[:0] = [str(a.tree / "src")]
            from repro_torch.kernels import build
            build.library()
            return 0
        print(json.dumps(one(a.tree, a.archs[0], a.seed, a.runs)))
        return 0
    trees = [t.resolve() for t in a.trees]
    procs = [_child(t, "--build-only") for t in trees]
    if any(p.wait() != 0 for p in procs):
        print("a tree's kernels did not build", file=sys.stderr)
        return 1
    results = []
    for arch in a.archs:
        for _ in range(a.pairs):
            for t in (trees[0], trees[1], trees[1], trees[0]):
                t0 = time.monotonic()
                p = _child(t, "--archs", arch, "--runs", str(a.runs),
                           "--seed", str(a.seed))
                out, _ = p.communicate()
                if p.returncode != 0:
                    print(f"{arch} on {t} failed", file=sys.stderr)
                    return 1
                r = json.loads(out.strip().splitlines()[-1])
                r["process_s"] = time.monotonic() - t0
                print(json.dumps(r), flush=True)
                results.append(r)
    for arch in a.archs:
        for t in trees:
            tps = [x for r in results if r["arch"] == arch
                   and r["tree"] == str(t) for x in r["tokens_per_s"]]
            print(f"{arch:14s} {t.name:10s} eager tok/s " + ", ".join(
                f"{x:.1f}" for x in tps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
