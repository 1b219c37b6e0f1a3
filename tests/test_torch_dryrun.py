"""The dry run and the cost tooling on H100 meshes (``launch.dryrun``,
``launch.hillclimb``, ``launch.roofline``, ``configs.shapes``,
``core.serving_quant.serving_params_struct``, ``launch.mesh.DryMesh``),
against the JAX package where it has the same function and against a
real gloo mesh where it stands in for one:

  * the shape suites and ``applicable_shapes`` equal JAX's for every
    arch; ``model_flops_for`` and ``useful_bytes_for`` equal JAX's for
    every assigned arch x applicable shape x serve-weights setting;
  * ``serving_params_struct`` gives the shapes and dtypes of
    ``quantize_for_serving``'s streams, leaf by leaf, at one shard, at
    two and for one rank's shard;
  * a reduced dense, MoE and SSM stack's train, prefill and decode steps
    at (2, 2): every rank's dry tally by kind (calls and payload bytes)
    equals a real gloo run of the same rank's step (one spawn, the rank
    function in ``test_torch_dryrun_ranks.py``), and the counted matmul
    FLOPs of its prefill (and decode, but the SSM's one-token recurrence,
    an outer product FlopCounterMode does not see as a matmul) equal
    ``FlopCounterMode``'s count of the rank's eager run on dense weights;
  * gemma2-2b, dbrx-132b and mamba2-370m, reduced, train and decode on a
    (2, 2, 2) dry mesh (the reference's ``test_dryrun_multipod_small``);
  * the production meshes, the CLI's JSON record and the hillclimb
    variants the count separates.
"""
import dataclasses
import json

import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import applicable_shapes as jax_applicable
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jax_shapes
from repro.launch.roofline import model_flops_for as jax_model_flops
from repro.launch.roofline import useful_bytes_for as jax_useful_bytes
from repro_torch.configs import (ASSIGNED_ARCHS, PAPER_ARCHS, _REGISTRY,
                                 ShapeSuite, applicable_shapes, get_config,
                                 get_shape, reduced_config, shapes)
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.serving_quant import (quantize_for_serving,
                                            serving_params_struct)
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import DryMesh, make_production_mesh, spawn
from repro_torch.models.model import init_params
from test_torch_dryrun_ranks import (FLOP_SUITES, STACKS, SUITES, cell,
                                     tally_job)

TIMEOUT_S = 300.0


def test_shape_suites_match_jax():
    assert shapes.ALL_SHAPES == tuple(
        ShapeSuite(**dataclasses.asdict(s)) for s in jax_shapes.ALL_SHAPES)
    for s in jax_shapes.ALL_SHAPES:
        assert dataclasses.asdict(get_shape(s.name)) == dataclasses.asdict(s)
    with pytest.raises(KeyError):
        get_shape("nope")


@pytest.mark.parametrize("arch", sorted(_REGISTRY))
def test_applicable_shapes_match_jax(arch):
    assert [s.name for s in applicable_shapes(get_config(arch))] == \
        [s.name for s in jax_applicable(jax_get_config(arch))]


def test_arch_lists_match_jax():
    from repro.configs import PAPER_ARCHS as JAX_PAPER
    assert ASSIGNED_ARCHS == JAX_ASSIGNED and PAPER_ARCHS == JAX_PAPER


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_and_useful_bytes_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for suite in applicable_shapes(cfg):
        jsuite = jax_shapes.get_shape(suite.name)
        assert rl.model_flops_for(cfg, suite) == jax_model_flops(jcfg,
                                                                 jsuite)
        for sw in ("qtensor", "fp16"):
            assert rl.useful_bytes_for(cfg, suite, sw) == pytest.approx(
                jax_useful_bytes(jcfg, jsuite, sw), rel=1e-12)


def _fields(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _fields(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _fields(v, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield path, (tuple(tree.shape), tree.dtype)
    elif tree is None:
        yield path, None
    else:
        yield path, (tuple((f, tuple(getattr(tree, f).shape),
                            getattr(tree, f).dtype)
                           for f in ("in_codes", "out_codes", "stream_pos",
                                     "is_out", "scale_in", "scale_out")),
                     tuple(tree.shape), getattr(tree, "first", None),
                     getattr(tree, "n_shards", None))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dbrx-132b",
                                  "whisper-medium", "mamba2-370m"])
@pytest.mark.parametrize("shards,only", [(1, None), (2, None), (2, 1)])
def test_serving_params_struct_matches_the_conversion(arch, shards, only):
    cfg = reduced_config(arch)
    qmc = QMCConfig(rho=0.3, granularity="subtile")
    real = quantize_for_serving(init_params(cfg, 0, device="cpu"), qmc,
                                tp_shards=shards, only_shard=only)
    meta = serving_params_struct(init_params(cfg, device="meta"), qmc,
                                 tp_shards=shards, only_shard=only)
    want, got = dict(_fields(real)), dict(_fields(meta))
    assert got == want
    assert any(isinstance(v, tuple) and isinstance(v[0], tuple)
               and len(v) == 4 for v in got.values())    # streams exist


@pytest.fixture(scope="module")
def gloo_tallies():
    """Every rank of one (2, 2) gloo spawn: its cells' tallies and FLOPs."""
    return spawn(tally_job, (2, 2), backend="gloo",
                 args=([n for n, _ in STACKS],), timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("stack", [n for n, _ in STACKS])
@pytest.mark.parametrize("suite", SUITES, ids=lambda s: s.kind)
def test_dry_tally_equals_a_gloo_run(gloo_tallies, stack, suite):
    for r in gloo_tallies:
        dry = cell(DryMesh((2, 2), ("data", "model"), r["rank"]), stack,
                   suite, "meta")["collectives"]
        real = r["cells"][(stack, suite.name)]
        assert real, f"rank {r['rank']} {stack} {suite.kind}: none ran"
        assert dry == real, (r["rank"], stack, suite.kind)


@pytest.mark.parametrize("stack,suite", [
    (n, s) for n, _ in STACKS for s in FLOP_SUITES
    # the one-token SSM recurrence's outer product is no matmul to
    # FlopCounterMode: its decode counts apart
    if not (n == "ssm" and s.kind == "decode")],
    ids=lambda v: v if isinstance(v, str) else v.kind)
def test_counted_matmul_flops_equal_flop_counter(gloo_tallies, stack,
                                                 suite):
    for r in gloo_tallies:
        counter, counted = r["flops"][(stack, suite.name)]
        assert counter > 0 and counted == counter, (r["rank"], stack,
                                                   suite.kind)


@pytest.mark.parametrize("arch", ["gemma2-2b", "dbrx-132b", "mamba2-370m"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dryrun_multipod_small(arch, kind):
    """Reduced stacks on a (2, 2, 2) dry mesh: the step composes, its
    collectives cross every axis it should, the count is positive."""
    cfg = reduced_config(arch)
    mesh = DryMesh((2, 2, 2), ("pod", "data", "model"), 5)
    suite = ShapeSuite(f"{kind}_t", kind, 16, 8)
    out = dryrun.lower_cell(arch, suite.name, multi_pod=True, mesh=mesh,
                            cfg=cfg, suite=suite)
    assert out["work"]["flops"] > 0 and out["work"]["bytes"] > 0
    assert out["arguments"]["params"] > 0
    if kind == "train":
        assert set(out["by_axis"]) == {"pod", "data", "model", "all"}
        assert out["collectives"]["grad_sum"]["calls"] >= 1
    else:
        assert "model" in out["by_axis"]


def test_production_meshes_are_h100_nodes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True, rank=511)
    assert single.shape == (32, 8) and single.axis_names == ("data",
                                                             "model")
    assert multi.shape == (2, 32, 8) and multi.coords == {
        "pod": 1, "data": 31, "model": 7}
    assert int(single.devices.size) == 256 and int(multi.devices.size) == 512


@pytest.mark.parametrize("multi_pod", [False, True])
def test_run_cell_records_a_cell(tmp_path, multi_pod):
    rec = dryrun.run_cell("stablelm-1.6b", "decode_32k",
                          multi_pod=multi_pod, out_dir=str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    on_disk = json.loads(next(tmp_path.iterdir()).read_text())
    assert on_disk["ok"] and on_disk["mesh"] == dryrun.MESH_NAMES[multi_pod]
    roof = on_disk["roofline"]
    assert roof["bottleneck"] == "memory" and roof["t_collective"] > 0
    assert on_disk["collective_bytes"]["intra_node"] > 0
    assert set(on_disk["memory"]) >= {"argument_bytes", "params_bytes",
                                      "cache_bytes"}


def test_cli_all_cells_listed_and_one_cell_runs(tmp_path):
    cells = dryrun.all_cells()
    assert len(cells) == 32          # 64 with both meshes
    assert ("mamba2-370m", "long_500k") in cells
    assert ("stablelm-1.6b", "long_500k") not in cells
    assert dryrun.main(["--arch", "whisper-medium", "--shape",
                        "prefill_32k", "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "whisper-medium", "--shape",
                        "prefill_32k", "--out", str(tmp_path),
                        "--skip-existing"]) == 0


def test_hillclimb_separates_kv8_and_not_chunked_ce(tmp_path):
    base = hillclimb.measure("stablelm-1.6b", "decode_32k", "qtensor", {})
    kv8 = hillclimb.measure("stablelm-1.6b", "decode_32k", "qtensor",
                            hillclimb.OPTS["kv8"])
    assert kv8["roofline"]["bytes_per_dev"] < \
        base["roofline"]["bytes_per_dev"]
    assert kv8["argument_bytes"] < base["argument_bytes"]
    cfg = dataclasses.replace(reduced_config("gemma2-2b"))
    suite = ShapeSuite("train_t", "train", 16, 64)
    mesh = DryMesh((2, 2), ("data", "model"))
    counts = {v: dryrun.lower_cell(
        "gemma2-2b", "train_t", multi_pod=False, mesh=mesh, suite=suite,
        cfg=dataclasses.replace(cfg, **hillclimb.OPTS[v]))["work"]
        for v in ("baseline", "chunked_ce", "both_dots")}
    assert counts["chunked_ce"] == counts["baseline"]
    assert counts["both_dots"]["flops"] < counts["baseline"]["flops"]
