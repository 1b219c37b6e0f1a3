"""Device time of the decode qmm at dbrx-132b's expert shapes (chip_smoke's
``check_expert_qmm``: w_up / w_gate 6144 x 10752, w_down 10752 x 6144,
4 rows padded to 8) on the weights that different states of chip_smoke's
random generator draw.

chip_smoke draws every kernel case of its phase 3 from one generator, in
order, so a case added before ``check_expert_qmm`` changes the expert
weights it times. This script runs phase 3's checks up to the sliced
attention as chip_smoke does, then replays the sliced cases' draws two
ways: the decode and chunk cases alone ("before": the draws of a tree
whose sliced check had only those two), then with the hymba case after
them ("now": the draws of the current check; the script prints whether
this reaches the generator state the real ``check_sliced_attention``
leaves).
It times ``check_expert_qmm`` from each state in the order A B B A, and
from ``--seeds`` fresh generators once each, and prints, per weight, the
kernel's ms (``chip_smoke.Timer``: median of 20 CUDA-event runs, L2
flushed) and how the outlier subtiles spread over the 128-column strips.
Then it times one w_up weight (the current draws') at ``--placements``
addresses: its streams and x copied anew each time, every earlier copy
kept alive, so each copy lands elsewhere in the card's memory.

    python scripts/torch_expert_qmm_draws.py --out build/draws.json

Needs a CUDA card; builds the kernels first.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.qconfig import QMCConfig  # noqa: E402
from repro_torch.core.qtensor import quantize_qtensor  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SLICED = {"decode": ([(69, 1), (192, 1), (239, 1), (0, 0)], 32, 1),
          "chunk": ([(0, 128), (64, 100), (200, 1), (0, 0)], 32, 1),
          "hymba": ([(2047, 1), (1800, 1), (1030, 1), (0, 0)], 5, 5)}


def replay(gen, names):
    """The generator draws of the sliced check's cases ``names``."""
    for name in names:
        lanes, n_kv, g = SLICED[name]
        cs.make_attn_case(lanes, n_kv=n_kv, g=g, hd=64, page=16,
                          quantized=False, gen=gen)


def spread(gen) -> list:
    """Per expert shape, the outlier subtiles of each 128-column strip of
    the weight ``check_expert_qmm`` draws next: min, mean, max."""
    out = []
    for k, n in cs.EXPERT_SHAPES:
        qt = quantize_qtensor(cs.make_weight(k, n, gen), QMCConfig(
            rho=0.3, granularity="subtile"))
        per = qt.is_out.sum(dim=0).cpu().numpy()
        out.append(dict(shape=f"K={k} N={n}", strip_min=int(per.min()),
                        strip_mean=float(per.mean()),
                        strip_max=int(per.max()),
                        outliers=int(per.sum()),
                        subtiles=int(qt.is_out.numel())))
        torch.randn((4, k), generator=gen, device="cuda")   # check's x
        del qt
    return out


def timed(timer, peak, gen, state) -> dict:
    gen.set_state(state)
    stats = spread(gen)
    gen.set_state(state)
    rows = []
    cs.check_expert_qmm(timer, peak, gen, rows)
    return dict(ms=[r["ms"] for r in rows], stats=stats)


def placements(timer, gen, state, n: int) -> list:
    """The w_up weight and x that ``check_expert_qmm`` draws from
    ``state``, timed as drawn and then at ``n`` fresh copies (with a pad
    of a different size allocated before each), every copy kept."""
    gen.set_state(state)
    k, n_out = cs.EXPERT_SHAPES[0]
    qt = quantize_qtensor(cs.make_weight(k, n_out, gen), QMCConfig(
        rho=0.3, granularity="subtile"))
    x = torch.zeros((8, k), device="cuda")
    x[:4] = torch.randn((4, k), generator=gen, device="cuda")
    kept, out = [], []
    for i in range(n + 1):
        if i:
            kept.append(torch.empty((i * 3 << 20) + i * 4096,
                                    dtype=torch.uint8, device="cuda"))
            qt = dataclasses.replace(
                qt, **{f: getattr(qt, f).clone() for f in (
                    "in_codes", "out_codes", "stream_pos", "is_out",
                    "scale_in", "scale_out")})
            x = x.clone()
            kept.append((qt, x))
        ms = timer(lambda: cs.qmm_decode(x, qt))
        out.append(dict(ms=ms, **{f"{f}_mod_2MiB": getattr(qt, f).data_ptr()
                                  % (2 << 20) for f in (
                                      "in_codes", "out_codes", "stream_pos")},
                        x_mod_2MiB=x.data_ptr() % (2 << 20)))
        print(f"[place] {i}: {out[-1]}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--placements", type=int, default=8)
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "expert_qmm_draws.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    bw, fl, tc, _ = cs.peaks(name)
    peak = (bw, fl, tc)
    t0 = time.monotonic()
    build.library()
    print(f"[build] {time.monotonic() - t0:.1f}s", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    timer = cs.Timer()
    rows = []
    cs.check_qmm(timer, peak, gen, rows)
    cs.check_patterns(timer, peak, gen, rows)
    cs.check_attention(timer, peak, gen, rows)
    base = gen.get_state()
    cs.check_sliced_attention(timer, peak, gen, rows)
    real = gen.get_state()
    gen.set_state(base)
    replay(gen, ("decode", "chunk"))
    before = gen.get_state()
    replay(gen, ("hymba",))
    now = gen.get_state()
    print(f"[draws] the replayed draws reach check_sliced_attention's "
          f"generator state: {torch.equal(now, real)}", flush=True)

    res = {}
    for label, state in (("before A", before), ("now B", now),
                         ("now B2", now), ("before A2", before)):
        res[label] = timed(timer, peak, gen, state)
        print(f"[draws] {label}: ms {res[label]['ms']}; outlier subtiles "
              f"per strip {res[label]['stats']}", flush=True)
    for s in range(1, args.seeds + 1):
        g = torch.Generator(device="cuda")
        g.manual_seed(1000 + s)
        res[f"seed {1000 + s}"] = timed(timer, peak, gen, g.get_state())
        print(f"[draws] seed {1000 + s}: ms {res[f'seed {1000 + s}']['ms']};"
              f" outlier subtiles per strip "
              f"{res[f'seed {1000 + s}']['stats']}", flush=True)
    placed = placements(timer, gen, now, args.placements)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(device=smi, results=res,
                                        placements=placed), indent=1))
    w_up = {k: v["ms"][0] for k, v in res.items()}
    seeds = [v for k, v in w_up.items() if k.startswith("seed")]
    ptp = f"{np.ptp(seeds):.4f}" if seeds else "none"
    print(f"[draws] {smi}: w_up ms by draw {w_up}; spread over fresh seeds "
          f"{ptp}; the current draws' w_up as drawn and at "
          f"{len(placed) - 1} copies: {[round(p['ms'], 4) for p in placed]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
