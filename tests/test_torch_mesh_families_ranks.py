"""MoE, SSM and hybrid stacks on the serving mesh, the port held to itself
(no JAX, so the ranks that ``tests/test_torch_mesh_families.py`` spawns
import this module quickly; its rank function lives here):

  * ``_shard_stream`` keeps a ``[G][E]`` QTensor expert list's experts
    whole under expert parallelism (``E % M == 0``: rank ``m``'s experts,
    ``None`` elsewhere) and cuts every expert at subtile boundaries under
    the Megatron fallback (columns for ``w_up``, rows for ``w_down``;
    whole where the cut would split a subtile), on stand-in meshes;
  * ``quantize_for_serving(tp_shards=2, only_shard=m)`` converts only rank
    ``m``'s experts, bit-equal to the whole conversion's, and the mesh
    passes that list through unchanged;
  * the bridge crosses only a rank's experts over;
  * ``obs.costs.step_work`` of an EP rank counts its experts' bytes only:
    the whole stack's expert bytes split between the ranks;
  * the mamba leaves' serving specs: ``in_proj`` column-cut, ``conv_w``
    whole, ``out_proj`` row-cut.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import QTensor
from repro_torch.core.serving_quant import (is_stream_leaf,
                                            quantize_for_serving)
from repro_torch.launch import serve as port_cli
from repro_torch.launch import sharding as shd
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear
from repro_torch.models.model import init_params
from repro_torch.models.moe import capacity
from repro_torch.obs.costs import step_work
from repro_torch.serve.paged_kv import PagedKVPool

QMC = QMCConfig(rho=0.3, granularity="subtile")
QT_FIELDS = ("in_codes", "out_codes", "stream_pos", "is_out", "scale_in",
             "scale_out")


class StandInMesh:
    """The parts of a ``launch.mesh.Mesh`` the sharding rules read."""

    def __init__(self, shape, coords=(0, 0)):
        self.axis_names = ("data", "model")
        self.devices = np.empty(shape, dtype=object)
        self.shape = tuple(shape)
        self.coords = dict(zip(self.axis_names, coords))

    def index(self, axis):
        return self.coords.get(axis, 0)


def _dropped(p, x, cfg) -> int:
    """Assignments past their expert's capacity in one ``moe_block`` call
    (the router's top-k over every row, as the block routes them)."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(linear(xf, p["router"]).to(torch.float32), -1)
    ids = torch.topk(probs, cfg.topk, dim=-1)[1].reshape(-1)
    counts = torch.bincount(ids, minlength=cfg.n_experts)
    return int(torch.clamp_min(counts - capacity(xf.shape[0], cfg),
                               0).sum())


def _expert_bytes(tree) -> int:
    """Bytes of the QTensor experts a (rank's) parameter tree holds."""
    if isinstance(tree, dict):
        return sum(_expert_bytes(v) for v in tree.values())
    if isinstance(tree, list) and tree and isinstance(tree[0], list):
        return sum(q.nbytes_container() for row in tree for q in row
                   if q is not None)
    return 0


def family_rank(mesh, job):
    """One rank of a scripted mesh run (``launch.serve.mesh_worker``) with
    every ``moe_block`` call's dropped assignments counted, and the bytes
    of the QTensor experts this rank holds of each model against the
    whole tree's."""
    drops = [0]
    plain = blocks.moe_block

    def counted(p, x, cfg, **kw):
        drops[0] += _dropped(p, x, cfg)
        return plain(p, x, cfg, **kw)
    blocks.moe_block = counted
    try:
        runs = port_cli.mesh_worker(mesh, job)
    finally:
        blocks.moe_block = plain
    held = {}
    for name, model in job["models"].items():
        whole = model.get("params") or params_from_numpy(
            model["params_np"], device=job["device"])
        held[name] = (_expert_bytes(shd.shard_params(whole, mesh)),
                      _expert_bytes(whole))
    return dict(runs=runs, drops=drops[0], expert_bytes=held)


# ---------------------------------------------------------------------------
# the rules on stand-in meshes
# ---------------------------------------------------------------------------
def _moe_cfg(e, d_ff=256):
    return ModelConfig(name=f"e{e}", family="moe", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=d_ff, vocab=128,
                       n_experts=e, topk=2, moe_pattern=(True,))


@pytest.fixture(scope="module")
def experts():
    """QMC streams of two MoE stacks: E = 4 (EP at M = 2) and E = 3 (the
    Megatron fallback); ``w_up`` [64, 256] and ``w_down`` [256, 64]
    (dense: 64 output columns do not tile)."""
    out = {}
    for e in (4, 3):
        cfg = _moe_cfg(e)
        out[e] = (cfg, quantize_for_serving(init_params(cfg, 0, device="cpu"),
                                            QMC, min_dim=64))
    return out


def test_experts_whole_under_expert_parallelism(experts):
    cfg, q = experts[4]
    whole = q["blocks"]["b0"]["ffn"]["w_up"]
    for m in range(2):
        local = shd.shard_params(q, StandInMesh((1, 2), (0, m)))
        row = local["blocks"]["b0"]["ffn"]["w_up"]
        assert len(row) == cfg.n_groups
        for g in range(cfg.n_groups):
            assert [i for i, qt in enumerate(row[g]) if qt is not None] \
                == [2 * m, 2 * m + 1]
            for i in (2 * m, 2 * m + 1):
                assert row[g][i] is whole[g][i]         # whole, uncut
        # dense w_down [G, E, ff, d]: the rank's experts (the JAX rule
        # with its data entry dropped)
        down = local["blocks"]["b0"]["ffn"]["w_down"]
        assert torch.equal(down, q["blocks"]["b0"]["ffn"]["w_down"][
            :, 2 * m:2 * m + 2])
        assert is_stream_leaf(row)
        # a second pass leaves the rank's list as it is
        again = shd.shard_params(local, StandInMesh((1, 2), (0, m)))
        assert again["blocks"]["b0"]["ffn"]["w_up"][0][2 * m] \
            is row[0][2 * m]


def test_experts_cut_under_the_megatron_fallback(experts):
    """E = 3 at M = 2: each ``w_up`` expert cut into 128 of its 256
    columns (the rank's plain QTensor, equal to ``shard_qtensor``'s
    slice); the dense ``w_down`` cut into 128 of its 256 rows."""
    cfg, q = experts[3]
    whole = q["blocks"]["b0"]["ffn"]["w_up"]
    for m in range(2):
        local = shd.shard_params(q, StandInMesh((2, 2), (1, m)))
        row = local["blocks"]["b0"]["ffn"]["w_up"]
        for g in range(cfg.n_groups):
            assert len(row[g]) == 3
            for i, qt in enumerate(row[g]):
                assert isinstance(qt, QTensor) and qt.shape == (64, 128)
                want = shd.shard_qtensor(whole[g][i], 2, 1, only=m).local(m)
                for f in QT_FIELDS:
                    assert torch.equal(getattr(qt, f), getattr(want, f))
        assert local["blocks"]["b0"]["ffn"]["w_down"].shape == (
            cfg.n_groups, 3, 128, 64)
    # a cut that would split a subtile (128 columns into 2 x 64) leaves
    # every expert whole
    cfg128 = _moe_cfg(3, d_ff=128)
    q128 = quantize_for_serving(init_params(cfg128, 0, device="cpu"), QMC,
                                min_dim=64)
    row = shd.shard_params(q128, StandInMesh((1, 2), (0, 1)))[
        "blocks"]["b0"]["ffn"]["w_up"][0]
    assert all(a is b for a, b in zip(
        row, q128["blocks"]["b0"]["ffn"]["w_up"][0]))


def test_only_shard_converts_the_ranks_experts(experts):
    cfg, q = experts[4]
    dense = init_params(cfg, 0, device="cpu")
    for m in range(2):
        own = quantize_for_serving(dense, QMC, min_dim=64, tp_shards=2,
                                   only_shard=m)
        for g in range(cfg.n_groups):
            row = own["blocks"]["b0"]["ffn"]["w_up"][g]
            assert [i for i, qt in enumerate(row) if qt is not None] \
                == [2 * m, 2 * m + 1]
            for i in (2 * m, 2 * m + 1):
                want = q["blocks"]["b0"]["ffn"]["w_up"][g][i]
                for f in QT_FIELDS:
                    assert torch.equal(getattr(row[i], f), getattr(want, f))
        local = shd.shard_params(own, StandInMesh((1, 2), (0, m)))
        assert local["blocks"]["b0"]["ffn"]["w_up"][0][2 * m] \
            is own["blocks"]["b0"]["ffn"]["w_up"][0][2 * m]
    # E = 3 does not divide 2: every expert converted, as the whole
    cfg3, q3 = experts[3]
    own = quantize_for_serving(init_params(cfg3, 0, device="cpu"), QMC,
                               min_dim=64, tp_shards=2, only_shard=1)
    assert all(qt is not None for qt in own["blocks"]["b0"]["ffn"][
        "w_up"][0])


def _numpy_experts(row_of_rows):
    """A ``[G][E]`` QTensor list as the bridge's numpy dict (``"stack":
    "experts"``)."""
    out = {f: np.stack([np.stack([getattr(q, f).numpy() for q in row])
                        for row in row_of_rows]) for f in QT_FIELDS}
    q = row_of_rows[0][0]
    out.update(shape=q.shape, bits_in=q.bits_in, bits_out=q.bits_out,
               subtile=q.subtile, stack="experts")
    return out


def test_bridge_crosses_a_ranks_experts(experts):
    cfg, q = experts[4]
    whole = q["blocks"]["b0"]["ffn"]["w_up"]
    tree = {"blocks": {"b0": {"ffn": {"w_up": _numpy_experts(whole)}}}}
    for m in range(2):
        got = params_from_numpy(tree, device="cpu",
                                mesh=StandInMesh((1, 2), (0, m)))
        row = got["blocks"]["b0"]["ffn"]["w_up"]
        for g in range(cfg.n_groups):
            assert [i for i, qt in enumerate(row[g]) if qt is not None] \
                == [2 * m, 2 * m + 1]
            assert torch.equal(row[g][2 * m].in_codes,
                               whole[g][2 * m].in_codes)


def _no_ffn(tree):
    return dict(tree, blocks={k: {n: v for n, v in blk.items()
                                  if n not in ("ffn", "norm2")}
                              for k, blk in tree["blocks"].items()})


def test_step_work_of_an_ep_rank_counts_its_experts(experts):
    """The MoE share of ``step_work`` (the count less that of the same
    tree without its FFNs) on each EP rank is over half and under all of
    one process's: the expert products and the ``[E, cap, d]`` buffers
    split between the ranks, the router and the token rows do not."""
    cfg, q = experts[4]
    pool = PagedKVPool(cfg, n_pages=9, page=8, max_slots=4,
                       max_pages_per_seq=4, device="cpu")
    arena = pool.init_arena()

    def moe_bytes(tree):
        return (step_work(cfg, tree, arena, lanes=4, c=1)["bytes"]
                - step_work(cfg, _no_ffn(tree), arena, lanes=4,
                            c=1)["bytes"])
    whole = moe_bytes(q)
    ranks = [moe_bytes(shd.shard_params(q, StandInMesh((1, 2), (0, m))))
             for m in range(2)]
    assert ranks[0] == ranks[1]
    assert whole / 2 < ranks[0] < whole


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_mamba_serving_specs(shape):
    mesh = StandInMesh(shape)

    class Leaf:
        def __init__(self, *s):
            self.shape = s
    assert shd.serving_spec("blocks/b0/mamba/in_proj", Leaf(2, 1024, 4384),
                            mesh) == (None, None, "model")
    assert shd.serving_spec("blocks/b0/mamba/conv_w", Leaf(2, 2304, 4),
                            mesh) == (None, None, None)
    assert shd.serving_spec("blocks/b0/mamba/out_proj", Leaf(2, 2048, 1024),
                            mesh) == (None, "model", None)
    # JAX cuts conv_w's channels over model; the mesh serves it whole
    assert shd.param_spec("blocks/b0/mamba/conv_w", Leaf(2, 2304, 4),
                          mesh)[1] == "model"
