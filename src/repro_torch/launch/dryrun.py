"""The dry run on H100 meshes (counterpart of ``repro.launch.dryrun``):
one rank's step of every (arch x shape) cell on the production meshes,
with no card and no value computed.

The reference lowers and compiles each cell for 512 host devices and
reads XLA's cost and memory analysis. The port has no compiler to ask,
so ``lower_cell`` builds the step a rank of ``launch.mesh.
make_production_mesh`` runs (32 nodes of 8 H100s, ``(32, 8)``, or two
such pods, ``(2, 32, 8)``) on ``device="meta"`` tensors and runs it
under that ``DryMesh``:

  * train cells: ``train.step.build_train_step`` on the rank's slices of
    the parameters and both AdamW moments (``launch.sharding.
    train_slices``) and its rows of the global batch;
  * prefill cells: ``serve.steps.build_prefill`` on the rank's slices of
    the dense weights and its cache (``sharding.local_cache``);
  * decode cells: ``serve.steps.build_decode`` on QMC streams quantized
    after the shard (``core.serving_quant.serving_params_struct`` at
    ``tp_shards = M``, the rank's shard alone; the streams of an
    attention block that replicates over ``model`` whole), or the dense
    weights with ``--serve-weights fp16``.

Running the step on ``meta`` tensors checks that every shape of the
rank's step composes at the cell's full size, and the ``DryMesh``
tallies each collective the step issues (kind, calls, payload bytes, and
bytes by axis) exactly as a real mesh of gloo ranks tallies them. The
work is counted, not measured: ``obs.costs.contiguous_work`` for a
prefill or a decode call, ``obs.costs.train_step_work`` for a training
step. The record holds per rank the FLOPs and bytes, the collectives by
kind, the argument bytes (the parameters, the optimizer state and the
cache a rank holds, and its inputs) and the roofline terms
(``launch.roofline``: the datasheet's peaks, not measurements).
``calibrated_cost`` has no counterpart: the reference corrects XLA's
count of a scan body, which counts once whatever its trip count; here
nothing is scanned and nothing is counted once.

Where the reference cuts the sequence over ``data`` (a batch that does
not divide the dp axes: ``long_500k``'s batch 1, ``prefill_32k``'s 32 on
the 64 dp ranks of two pods), the port replicates the rows over the dp
axes (``sharding.cache_spec``), so such a cell counts every row on every
rank.

Usage::

  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch import runtime_context as ctx
from repro_torch import tree as T
from repro_torch.configs import (ASSIGNED_ARCHS, applicable_shapes,
                                 get_config, get_shape)
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.serving_quant import (quantize_for_serving,
                                            serving_params_struct)
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as shd
from repro_torch.models.layers import attn_replicated
from repro_torch.models.model import init_params
from repro_torch.obs.costs import contiguous_work, train_step_work
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve import steps as serve_steps
from repro_torch.train.step import build_train_step

DTYPE = torch.bfloat16
MESH_NAMES = {False: "node32x8", True: "pod2x32x8"}


def params_struct(cfg, dtype=DTYPE) -> dict:
    """The whole parameter tree's shapes (``meta``)."""
    return init_params(cfg, device="meta", dtype=dtype)


def input_specs(cfg, suite, *, batch: Optional[int] = None,
                device="meta", dtype=DTYPE,
                gen: Optional[torch.Generator] = None) -> Dict:
    """Every model input of this cell at the global batch: ``meta``
    stand-ins, or on a real ``device`` values drawn from ``gen``."""
    b = batch or suite.global_batch
    s = suite.seq_len

    def ids(shape):
        if device == "meta":
            return torch.empty(shape, dtype=torch.int64, device="meta")
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             device=device)

    def e(shape):
        if device == "meta":
            return torch.empty(shape, dtype=dtype, device="meta")
        return 0.1 * torch.randn(shape, generator=gen, device=device,
                                 dtype=dtype)
    if suite.kind == "train":
        spec = {"tokens": ids((b, s)), "labels": ids((b, s))}
    elif suite.kind == "prefill":
        spec = {"tokens": ids((b, s))}
    else:  # decode
        spec = {"tokens": ids((b, 1))}
    if cfg.n_vis_tokens and suite.kind in ("train", "prefill"):
        spec["vis_embeds"] = e((b, cfg.n_vis_tokens, cfg.d_model))
    if cfg.is_encdec and suite.kind in ("train", "prefill"):
        spec["frames"] = e((b, cfg.enc_seq, cfg.d_model))
    return spec


def _moment_dtype(cfg) -> str:
    # giant models: bf16 moments, as the reference's dry run has them
    return "bfloat16" if cfg.param_count() > 3e10 else "float32"


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree (QTensor fields, expert lists and
    the optimizer state's moments too)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return sum(tree_bytes(getattr(tree, f))
                   for f in tree.__dataclass_fields__)
    return 0


def decode_params(cfg, params, mesh, serve_weights: str):
    """A rank's decode weights: QMC streams quantized after the shard
    (its shard alone; ``serving_params_struct`` on a ``meta`` tree), an
    attention block that replicates over ``model`` quantized whole; or
    the dense weights (``fp16``)."""
    if serve_weights != "qtensor":
        return params
    qmc = QMCConfig(rho=0.3, granularity="subtile")
    convert = (serving_params_struct
               if T.leaves(params)[0].device.type == "meta"
               else quantize_for_serving)
    m = meshlib.axis_size(mesh, "model")
    cut = convert(params, qmc, tp_shards=m, only_shard=mesh.index("model"))
    whole = convert(params, qmc) if attn_replicated(cfg, m) else cut

    def pick(a, b, path):
        if isinstance(a, dict):
            return {k: pick(a[k], b[k], f"{path}/{k}" if path else k)
                    for k in a}
        return b if shd.replicated_attn_leaf(path, cfg, mesh) else a
    return pick(cut, whole, "")


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               serve_weights: str = "qtensor", microbatches: int = 1,
               mesh=None, cfg=None, suite=None, device="meta",
               dtype=DTYPE, seed: int = 0) -> Dict:
    """Build one rank's step of the cell and run it under ``mesh`` (the
    dry mesh ``make_production_mesh``, rank 0, unless given); returns
    ``{"cfg", "suite", "mesh", "work", "collectives", "by_axis",
    "arguments", "run_s"}``. On ``device="meta"`` nothing is computed;
    on a real device (a gloo rank of a real mesh, in the tests) the same
    step runs on seeded weights and inputs, so the two tallies can be
    held against each other."""
    cfg = cfg or get_config(arch)
    suite = suite or get_shape(shape_name)
    if mesh is None:
        mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
    mesh.reset_counts()
    if device == "meta":
        whole, gen = params_struct(cfg, dtype), None
    else:
        whole = init_params(cfg, seed, device=device, dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
    spec = input_specs(cfg, suite, device=device, dtype=dtype, gen=gen)
    b = suite.global_batch
    rows_idx = shd.batch_rows(mesh, b, microbatches)
    inputs = {k: v[rows_idx] for k, v in spec.items()}
    rows = inputs["tokens"].shape[0]
    args: Dict[str, int] = {"inputs": tree_bytes(inputs)}
    t0 = time.monotonic()
    if suite.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=_moment_dtype(cfg))
        specs = shd.train_specs(whole, mesh, cfg)
        local = shd.train_slices(whole, mesh, specs)
        opt = adamw.init(local, opt_cfg)
        args.update(params=tree_bytes(local), optimizer=tree_bytes(opt.m)
                    + tree_bytes(opt.v))
        step = build_train_step(cfg, opt_cfg, mesh,
                                microbatches=microbatches)
        step(local, opt, inputs)
        moments = 2 if opt_cfg.moment_dtype == "bfloat16" else 4
        work = train_step_work(
            cfg, mesh, tokens=rows * suite.seq_len,
            remat=cfg.remat_policy == "full",
            enc_tokens=rows * cfg.enc_seq if cfg.is_encdec else 0,
            vis_tokens=rows * cfg.n_vis_tokens,
            itemsize=dtype.itemsize, moment_itemsize=moments)
    else:
        if suite.kind == "prefill":
            weights = whole
            cache_len = suite.seq_len + cfg.n_vis_tokens
        else:
            weights = decode_params(cfg, whole, mesh, serve_weights)
            cache_len = suite.seq_len
        local = shd.shard_params(weights, mesh, cfg)
        cache = shd.local_cache(cfg, b, cache_len, dtype, device, mesh)
        args.update(params=tree_bytes(local), cache=tree_bytes(cache))
        with torch.no_grad():
            if suite.kind == "prefill":
                fn = serve_steps.build_prefill(cfg, mesh, batch=b,
                                               seq=suite.seq_len,
                                               cache_len=cache_len,
                                               cache_dtype=dtype)
                extras = {k: v for k, v in inputs.items() if k != "tokens"}
                fn(local, inputs["tokens"], extras, cache)
                s = suite.seq_len
            else:
                fn = serve_steps.build_decode(cfg, mesh, batch=b,
                                              cache_len=cache_len)
                fn(local, inputs["tokens"], cache,
                   torch.tensor(suite.seq_len - 1, device=device))
                s = 1
        split = meshlib.dp_size(mesh) if shd.batch_spec(mesh, b) else 1
        work = contiguous_work(cfg, local, cache, rows=rows, s=s, dp=split)
    run_s = time.monotonic() - t0
    return {"cfg": cfg, "suite": suite, "mesh": mesh, "work": work,
            "collectives": {k: {"calls": v[0], "bytes": v[2]}
                            for k, v in sorted(mesh.by_kind.items())},
            "by_axis": dict(mesh.by_axis), "arguments": args,
            "run_s": run_s}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             serve_weights: str = "qtensor",
             out_dir: Optional[str] = None) -> Dict:
    """One cell's record (``ok``, the counts, the roofline, or the error),
    written to ``out_dir`` as one JSON file when given."""
    mesh_name = MESH_NAMES[multi_pod]
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "serve_weights": serve_weights, "ok": False}
    t0 = time.monotonic()
    try:
        with ctx.use_mesh(None):
            out = lower_cell(arch, shape_name, multi_pod=multi_pod,
                             serve_weights=serve_weights)
        cfg, suite, mesh = out["cfg"], out["suite"], out["mesh"]
        chips = int(mesh.devices.size)
        rec["run_s"] = out["run_s"]
        rec["cost"] = {"flops": out["work"]["flops"],
                       "bytes accessed": out["work"]["bytes"]}
        rec["collectives"] = out["collectives"]
        total = sum(out["by_axis"].values())
        rec["collective_bytes"] = {
            "total": total, "intra_node": out["by_axis"].get("model", 0),
            "by_axis": out["by_axis"]}
        rec["memory"] = {"argument_bytes": sum(out["arguments"].values()),
                         **{f"{k}_bytes": v
                            for k, v in out["arguments"].items()}}
        roof = rl.from_artifacts(
            arch, shape_name, mesh_name, chips, rec["cost"],
            rec["collective_bytes"], rl.model_flops_for(cfg, suite),
            rl.useful_bytes_for(cfg, suite, serve_weights),
            act_dtype=str(DTYPE).replace("torch.", ""))
        rec["roofline"] = roof.to_dict()
        rec["peaks"] = ("NVIDIA H100 SXM5 datasheet figures, not "
                        "measurements (launch/roofline.py)")
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 - record and continue
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = time.monotonic() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(cell_path(out_dir, arch, shape_name, multi_pod,
                            serve_weights), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def cell_path(out_dir: str, arch: str, shape: str, multi_pod: bool,
              serve_weights: str) -> str:
    sw = (f"_{serve_weights}" if get_shape(shape).kind == "decode"
          else "")
    return os.path.join(out_dir,
                        f"{arch}_{shape}_{MESH_NAMES[multi_pod]}{sw}.json")


def all_cells():
    """Every assigned arch x applicable shape."""
    return [(arch, suite.name) for arch in ASSIGNED_ARCHS
            for suite in applicable_shapes(get_config(arch))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--serve-weights", default="qtensor",
                    choices=["qtensor", "fp16"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_ok = n_fail = 0
    t0 = time.monotonic()
    for arch, shape in cells:
        for mp in meshes:
            path = cell_path(args.out, arch, shape, mp, args.serve_weights)
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        print(f"[skip] {arch} {shape} {MESH_NAMES[mp]}")
                        n_ok += 1
                        continue
            rec = run_cell(arch, shape, multi_pod=mp,
                           serve_weights=args.serve_weights,
                           out_dir=args.out)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
            roof = rec.get("roofline", {})
            print(f"[{'OK ' if rec['ok'] else 'FAIL'}] {arch:22s} "
                  f"{shape:12s} {MESH_NAMES[mp]:10s} "
                  f"run={rec.get('run_s', 0):6.2f}s "
                  f"bottleneck={roof.get('bottleneck', '-'):10s} "
                  f"frac={roof.get('roofline_fraction', 0):.3f} "
                  f"{rec.get('error', '')}", flush=True)
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed in "
          f"{time.monotonic() - t0:.1f}s")
    return 0 if n_fail == 0 else 1


__all__ = ["params_struct", "input_specs", "lower_cell", "run_cell",
           "main", "all_cells", "tree_bytes", "decode_params"]

if __name__ == "__main__":
    raise SystemExit(main())
