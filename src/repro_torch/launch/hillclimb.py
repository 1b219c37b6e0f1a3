"""Perf hillclimbing harness (counterpart of ``repro.launch.hillclimb``):
the roofline terms of a cell under named optimization variants, through
the dry run (``launch.dryrun.lower_cell`` on the single-node production
mesh, ``(32, 8)`` H100s), logged as one JSON record a cell to
``build/hillclimb/``.

  python -m repro_torch.launch.hillclimb --cell gemma2_train
  python -m repro_torch.launch.hillclimb --all

``OPTS`` and ``CELLS`` are the reference's. What the port's count can
and cannot separate:

  * ``kv8`` (``kv_cache_quant``): the int8 cache and its bf16 scales
    change the decode's counted bytes and the cache a rank holds;
  * ``both_dots`` (``remat_policy="dots"``): the saved matmul outputs
    drop the layers' recompute from the counted FLOPs and bytes;
  * ``chunked_ce`` and ``chunked_attn`` change the step's peak memory
    (the logits and the attention scores held at once), which the count
    does not read: their records equal the baseline's (and ``both``
    equals it too). The reference's XLA count differs on them only
    through fusion and temporaries, which the port has no compiler to
    report.

The terms are counts against the H100 SXM5 datasheet's peaks
(``launch.roofline``), not measurements.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import DTYPE, MESH_NAMES, lower_cell

OUT = "build/hillclimb"

# variant -> ModelConfig field overrides (cumulative per cell plan)
OPTS = {
    "baseline": {},
    "chunked_ce": {"chunked_ce": True},
    "chunked_attn": {"chunked_attn": True},
    "both": {"chunked_ce": True, "chunked_attn": True},
    "both_dots": {"chunked_ce": True, "chunked_attn": True,
                  "remat_policy": "dots"},
    "kv8": {"kv_cache_quant": True},
    "both_kv8": {"chunked_ce": True, "chunked_attn": True,
                 "kv_cache_quant": True},
}

# The reference's hillclimb cells:
#   gemma2_train  — worst train roofline fraction (256k-vocab CE dominates)
#   dbrx_decode   — most collective-bound decode (MoE + QMC serving)
#   stablelm_dec  — paper-representative SLM edge decode (memory-bound);
#                   also FP16-weights vs QMC-weights serving.
CELLS = {
    "gemma2_train": dict(arch="gemma2-2b", shape="train_4k",
                         serve_weights="fp16",
                         variants=["baseline", "chunked_ce",
                                   "chunked_attn", "both", "both_dots"]),
    "dbrx_decode": dict(arch="dbrx-132b", shape="decode_32k",
                        serve_weights="qtensor",
                        variants=["baseline", "kv8"]),
    "stablelm_decode": dict(arch="stablelm-1.6b", shape="decode_32k",
                            serve_weights="qtensor",
                            variants=["baseline", "kv8"]),
    "stablelm_decode_fp16": dict(arch="stablelm-1.6b", shape="decode_32k",
                                 serve_weights="fp16",
                                 variants=["baseline", "kv8"]),
}


def measure(arch: str, shape: str, serve_weights: str,
            overrides: Dict) -> Dict:
    """One variant's roofline terms and collectives on the single-node
    production mesh."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    suite = get_shape(shape)
    t0 = time.monotonic()
    out = lower_cell(arch, shape, multi_pod=False,
                     serve_weights=serve_weights, cfg=cfg, suite=suite)
    coll = {"total": sum(out["by_axis"].values()),
            "intra_node": out["by_axis"].get("model", 0)}
    roof = rl.from_artifacts(
        arch, shape, MESH_NAMES[False], int(out["mesh"].devices.size),
        {"flops": out["work"]["flops"],
         "bytes accessed": out["work"]["bytes"]}, coll,
        rl.model_flops_for(cfg, suite),
        rl.useful_bytes_for(cfg, suite, serve_weights),
        act_dtype=str(DTYPE).replace("torch.", ""))
    return {"roofline": roof.to_dict(), "collectives": out["collectives"],
            "argument_bytes": sum(out["arguments"].values()),
            "wall_s": time.monotonic() - t0}


def run_cell(name: str, out_dir: str = OUT) -> Dict:
    plan = CELLS[name]
    results = {}
    for variant in plan["variants"]:
        try:
            r = measure(plan["arch"], plan["shape"], plan["serve_weights"],
                        OPTS[variant])
        except Exception as e:  # noqa: BLE001
            r = {"error": f"{type(e).__name__}: {e}"}
        results[variant] = r
        roof = r.get("roofline", {})
        print(f"[{name}/{variant}] "
              f"t_comp={roof.get('t_compute', 0):.3e} "
              f"t_mem={roof.get('t_memory', 0):.3e} "
              f"t_coll={roof.get('t_collective', 0):.3e} "
              f"frac={roof.get('roofline_fraction', 0):.4f} "
              f"{r.get('error', '')}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump({"cell": name, "plan": dict(plan), "results": results},
                  f, indent=1, default=str)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default=None, choices=list(CELLS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    names = list(CELLS) if args.all or not args.cell else [args.cell]
    for n in names:
        run_cell(n, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
