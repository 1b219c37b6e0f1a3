"""The port's sharding rules, its TP stream format and the sliced ragged
paged attention against the JAX package's, in one process on the CPU.

  * Rules: every leaf of the JAX parity configs (and leaves whose dims do
    not divide) gets the JAX ``param_spec`` / ``_qtensor_field_spec`` /
    ``paged_cache_spec`` from the port's rules, on stand-in meshes (1, 2),
    (2, 1) and (2, 2) with no processes; serving drops the FSDP ``data``
    entries; every rank's slice of a leaf tiles it.
  * Streams: ``quantize_qtensor_sharded`` and ``quantize_for_serving(
    tp_shards=2)`` convert the same leaves as JAX, codes equal and scales
    at rtol 1e-5 (as ``test_torch_qtensor.py``); a rank's ``only_shard``
    equals the whole conversion's shard; ``shard_qtensor`` cuts the
    streams of one QTensor exactly.
  * Shard math: the column shards' outputs concatenated and the row
    shards' partial products summed against JAX ``qmm_sharded_ref`` at
    1e-5.
  * B1 over page slices: the sliced plain version over 2 and 4 slices,
    merged, against the JAX kernel (interpret mode, unsharded) at 1e-5,
    on ragged chunk and decode lanes, fp32 and int8 pages, window and
    softcap, and a slice with no live page; the span plan's pages summed
    over the slices equal the unsliced plan's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_ragged_case
from repro.core.qconfig import QMCConfig as JaxQMCConfig
from repro.core.qtensor_sharded import ShardedQTensor as JaxSQT
from repro.core.qtensor_sharded import qmm_sharded_ref as jax_qmm_sharded
from repro.core.qtensor_sharded import \
    quantize_qtensor_sharded as jax_quantize_sharded
from repro.core.serving_quant import quantize_for_serving as jax_q4s
from repro.kernels.paged_attention import ragged_paged_attention as jax_rpa
from repro.launch import sharding as jax_shd
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import init_params as jax_init_params
from repro.serve import steps as jax_steps
from repro_torch.bridge import arena_from_numpy, params_from_numpy
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import QTensor, dequantize_qtensor
from repro_torch.core.qtensor_sharded import (ShardedQTensor,
                                              dequantize_sharded,
                                              qmm_sharded_ref,
                                              quantize_qtensor_sharded,
                                              shard_qtensor)
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import (merge_slices, slice_runs,
                                                 span_plan)
from repro_torch.kernels.ref import ragged_paged_attention_ref
from repro_torch.launch import sharding as shd
from repro_torch.serve import steps as port_steps
from repro_torch.tree import items
from test_torch_bridge import QT_FIELDS, jax_tree_to_numpy

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=64)
TQ = dict(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
          vocab=128)
QMC = dict(rho=0.3, granularity="subtile")


class StandInMesh:
    """``axis_names`` and ``devices.shape`` as a JAX mesh has them, and
    the coordinates of one rank: the rules need nothing else."""

    def __init__(self, shape, coords=(0, 0)):
        self.axis_names = ("data", "model")
        self.devices = np.empty(shape, dtype=object)
        self.coords = dict(zip(self.axis_names, coords))

    def index(self, axis):
        return self.coords[axis]


SHAPES = [(1, 2), (2, 1), (2, 2)]


class Leaf:
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(shape)


def _ranks(shape):
    return [StandInMesh(shape, (d, m)) for d in range(shape[0])
            for m in range(shape[1])]


@functools.lru_cache(maxsize=None)
def _leaves():
    """(path, shape) of every leaf of the two parity configs, plus leaves
    whose sharded dims do not divide 2."""
    out = {}
    for name, base in (("t", BASE), ("tq", TQ)):
        cfg = JaxModelConfig(name=name, family="dense", **base)
        tree = jax_tree_to_numpy(jax_init_params(cfg,
                                                 jax.random.PRNGKey(0)))
        for path, leaf in items(tree):
            out[f"{name}:{path}"] = leaf.shape
    out["odd:embed/tok"] = (92553, 64)
    out["odd:lm_head"] = (64, 92553)
    out["odd:blocks/b0/attn/wq"] = (2, 64, 25 * 5)
    out["odd:blocks/b0/ffn/w_down"] = (2, 75, 64)
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_param_rules_match_jax(shape):
    mesh = StandInMesh(shape)
    odd = 0
    for key, leaf_shape in _leaves().items():
        path = key.split(":", 1)[1]
        want = tuple(jax_shd.param_spec(path, Leaf(leaf_shape), mesh))
        want += (None,) * (len(leaf_shape) - len(want))
        got = shd.param_spec(path, Leaf(leaf_shape), mesh)
        assert got == want, (key, got, want)
        serve = shd.serving_spec(path, Leaf(leaf_shape), mesh)
        assert serve == tuple(None if a == "data" else a for a in want)
        if key.startswith("odd:") and shape[1] > 1:
            odd += "model" not in serve        # replicated, as _finalize
    if shape[1] > 1:
        assert odd == 4


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_every_ranks_slice_tiles_the_leaf(shape):
    """Dense leaves of the tq config: the model ranks' slices along the
    model dim cover the leaf once; data ranks hold the same slice."""
    cfg = JaxModelConfig(name="tq", family="dense", **TQ)
    tree = params_from_numpy(jax_tree_to_numpy(
        jax_init_params(cfg, jax.random.PRNGKey(0))), device="cpu")
    locals_ = [shd.shard_params(tree, mesh) for mesh in _ranks(shape)]
    for path, leaf in items(tree):
        spec = shd.serving_spec(path, leaf, StandInMesh(shape))
        parts = [dict(items(t))[path] for t in locals_]
        if "model" not in spec:
            assert all(p is leaf for p in parts), path
            continue
        dim = spec.index("model")
        by_m = parts[:shape[1]]
        torch.testing.assert_close(torch.cat(by_m, dim=dim), leaf,
                                   rtol=0, atol=0)
        if shape[0] > 1:
            for a, b in zip(by_m, parts[shape[1]:]):
                assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_qtensor_field_and_arena_rules_match_jax(shape):
    mesh = StandInMesh(shape)
    fields = {"in_codes": (2, 2, 5, 8, 128), "out_codes": (2, 2, 3, 8, 128),
              "stream_pos": (2, 2, 16, 1), "is_out": (2, 2, 16, 1),
              "scale_in": (2, 1, 128), "scale_out": (3, 1, 128)}
    for f, s in fields.items():
        for lead in range(3):
            leaf = Leaf(s[len(s) - lead - (3 if "codes" in f else 2):])
            want = tuple(jax_shd._qtensor_field_spec(f"w/{f}", leaf, mesh))
            got = shd._qtensor_field_spec(f"w/{f}", leaf, mesh)
            assert got == want, (f, leaf.shape)
    arena = {"b0/attn/k_pages": (2, 16, 8, 32),
             "b0/attn/k_scale_pages": (2, 16, 8, 2),
             "b0/attn/v_pages": (2, 15, 8, 31),          # replicate
             "b0/attn/block_tbl": (2, 4, 4),
             "b0/mamba/ssm": (2, 4, 4, 16, 16)}
    for path, s in arena.items():
        want = tuple(jax_shd.paged_cache_spec(path, Leaf(s), mesh))
        assert shd.paged_cache_spec(path, Leaf(s), mesh) == want, path


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_arena_slices_and_pool_size(shape):
    """Rank (d, m) holds pages [d n, (d + 1) n) of its KV heads (plus the
    zero sink page when D > 1); the default pool rounds up as JAX's."""
    mesh = StandInMesh(shape)
    assert port_steps.default_n_pages(4, 4, mesh) == \
        jax_steps.default_n_pages(4, 4, mesh)
    rng = np.random.default_rng(0)
    pages = torch.tensor(rng.standard_normal((2, 16, 8, 2 * 16)),
                         dtype=torch.float32)
    arena = {"b0": {"attn": {"k_pages": pages,
                             "block_tbl": torch.zeros((2, 4, 4),
                                                      dtype=torch.int32)}}}
    d_n, m_n = shape
    for rk in _ranks(shape):
        got = shd.shard_arena(arena, rk)["b0"]["attn"]
        d, m = rk.coords["data"], rk.coords["model"]
        n, kv = 16 // d_n, 32 // m_n
        want = pages[:, d * n:(d + 1) * n, :, m * kv:(m + 1) * kv]
        assert torch.equal(got["k_pages"][:, :n], want)
        assert got["k_pages"].shape[1] == n + (d_n > 1)
        if d_n > 1:
            assert (got["k_pages"][:, n] == 0).all()
        assert shd.page_slice(16, rk) == (d * n, n)


# ---------------------------------------------------------------------------
# the TP stream format
# ---------------------------------------------------------------------------
def _assert_qt_equal(port_qt, jax_fields):
    for f in QT_FIELDS:
        got = getattr(port_qt, f).numpy()
        want = np.asarray(jax_fields[f])
        if f.startswith("scale"):
            np.testing.assert_allclose(got, want, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "cols"])
def test_quantize_qtensor_sharded_matches_jax(axis):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((128, 256)).astype(np.float32)
    jq = jax_quantize_sharded(jnp.asarray(w), JaxQMCConfig(**QMC), 2, axis,
                              use_int4=False)
    pq = quantize_qtensor_sharded(torch.tensor(w), QMCConfig(**QMC), 2,
                                  axis)
    assert pq.n_shards == 2 and pq.shard_axis == axis
    assert pq.shape == tuple(jq.shape)
    for i in range(2):
        _assert_qt_equal(pq.local(i), {f: getattr(jq, f)[i]
                                       for f in QT_FIELDS})
        one = quantize_qtensor_sharded(torch.tensor(w), QMCConfig(**QMC),
                                       2, axis, only=i)
        assert list(one.held) == [i]
        for f in QT_FIELDS:
            assert torch.equal(getattr(one.local(i), f),
                               getattr(pq.local(i), f))
    from repro.core.qtensor_sharded import dequantize_sharded as jax_deq
    np.testing.assert_allclose(
        dequantize_sharded(pq, torch.float32).numpy(),
        np.asarray(jax_deq(jq, jnp.float32)), rtol=1e-5, atol=0)


@functools.lru_cache(maxsize=None)
def _jax_tq():
    """JAX's tq parameters and their tp_shards=2 serving conversion (its
    eager PTQ takes ~20 s on the CPU: made once for the module)."""
    cfg = JaxModelConfig(name="tq", family="dense", **TQ)
    jp = jax_init_params(cfg, jax.random.PRNGKey(0))
    return jp, jax_q4s(jp, JaxQMCConfig(**QMC), tp_shards=2, min_dim=64)


def test_quantize_for_serving_tp2_matches_jax():
    """tq at ``tp_shards=2``: the same leaves become 2-shard streams (and
    the same fall back to one shard or stay dense) with JAX's codes; the
    bridge carries JAX's shards across unchanged."""
    jp, jq = _jax_tq()
    port = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    pq = quantize_for_serving(port, QMCConfig(**QMC), min_dim=64,
                              tp_shards=2)
    bridged = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    n_sqt = 0
    for path, leaf in _stream_leaves(pq):
        jleaf = _jax_at(jq, path)
        if isinstance(leaf, ShardedQTensor):
            n_sqt += 1
            assert isinstance(jleaf, JaxSQT) and jleaf.n_shards == 2
            assert leaf.shard_axis == jleaf.shard_axis
            for i in range(2):
                _assert_qt_equal(leaf.local(i), {
                    f: getattr(jleaf, f)[i] for f in QT_FIELDS})
            got = _bridged_at(bridged, path)     # JAX's own shards
            for f in QT_FIELDS:
                want = getattr(jleaf, f)
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(),
                    np.asarray(want.astype(jnp.int8) if f == "in_codes"
                               else want))
        elif isinstance(leaf, QTensor):
            assert isinstance(jleaf, JaxSQT) and jleaf.n_shards == 1
            _assert_qt_equal(leaf, {f: getattr(jleaf, f)[0]
                                    for f in QT_FIELDS})
        else:
            assert not isinstance(jleaf, JaxSQT), path
    assert n_sqt >= 6
    # a rank quantizing its own shard gets the whole conversion's shard
    for m in range(2):
        own = quantize_for_serving(port, QMCConfig(**QMC), min_dim=64,
                                   tp_shards=2, only_shard=m)
        for path, leaf in _stream_leaves(own):
            if isinstance(leaf, ShardedQTensor):
                whole = dict(_stream_leaves(pq))[path]
                for f in QT_FIELDS:
                    assert torch.equal(getattr(leaf.local(m), f),
                                       getattr(whole.local(m), f))


def _stream_leaves(tree, path=""):
    """(path, leaf) of every parameter, stacked lists indexed by group."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _stream_leaves(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for g, v in enumerate(tree):
            yield from _stream_leaves(v, f"{path}#{g}")
    else:
        yield path, tree


def _jax_at(tree, path):
    name, _, g = path.partition("#")
    leaf = tree
    for k in name.split("/"):
        leaf = leaf[k]
    if g and isinstance(leaf, JaxSQT):
        return jax.tree_util.tree_map(lambda x: x[int(g)], leaf)
    if g:
        return None
    return leaf


def _bridged_at(tree, path):
    name, _, g = path.partition("#")
    leaf = tree
    for k in name.split("/"):
        leaf = leaf[k]
    return leaf[int(g)] if g else leaf


@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "cols"])
def test_shard_qtensor_cuts_the_streams_exactly(axis):
    from repro_torch.core.qtensor import quantize_qtensor
    rng = np.random.default_rng(2)
    w = torch.tensor(rng.standard_normal((256, 512)).astype(np.float32))
    qt = quantize_qtensor(w, QMCConfig(**QMC))
    whole = dequantize_qtensor(qt, torch.float32)
    for n in (2, 4):
        cut = shard_qtensor(qt, n, axis)
        assert cut.n_shards == n
        torch.testing.assert_close(dequantize_sharded(cut, torch.float32),
                                   whole, rtol=0, atol=0)
        for i in range(n):
            one = shard_qtensor(qt, n, axis, only=i)
            torch.testing.assert_close(
                dequantize_qtensor(one.local(i), torch.float32),
                torch.chunk(whole, n, dim=axis)[i], rtol=0, atol=0)
    assert shard_qtensor(qt, 8, 1) is None      # 64 columns split a subtile


@pytest.mark.parametrize("axis", [0, 1], ids=["row", "column"])
def test_shard_math_matches_jax_qmm_sharded_ref(axis):
    """Each shard's qmm (the rank's matmul): column outputs concatenated,
    row partial products of x's K slices summed, against JAX's oracle."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((256, 512)).astype(np.float32)
    x = rng.standard_normal((5, 256)).astype(np.float32)
    jq = jax_quantize_sharded(jnp.asarray(w), JaxQMCConfig(**QMC), 2, axis,
                              use_int4=False)
    want = np.asarray(jax_qmm_sharded(jnp.asarray(x), jq))
    sq = params_from_numpy(jax_tree_to_numpy({"w": jq}), device="cpu")["w"]
    tx = torch.tensor(x)
    parts = [kops.qmm(torch.chunk(tx, 2, dim=1)[i] if axis == 0 else tx,
                      sq.local(i)) for i in range(2)]
    got = parts[0] + parts[1] if axis == 0 else torch.cat(parts, dim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(qmm_sharded_ref(tx, sq).numpy(), want,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# B1 over page slices
# ---------------------------------------------------------------------------
MIXED = ((0, 0), (0, 1), (3, 5), (8, 8), (13, 24), (40, 1), (5, 16))


def _slices(n_pages, k):
    """``k`` contiguous slices covering the pages, then the null page
    alone and the rest (a slice with no live page)."""
    bounds = np.linspace(0, n_pages, k + 1).astype(int)
    return [(int(a), int(b - a)) for a, b in zip(bounds, bounds[1:])]


def _sliced(tq, tc, tqs, tkl, page_slice, **kw):
    first, n = page_slice
    local = {k: (v[first:first + n] if k.endswith("_pages") else v)
             for k, v in tc.items()}
    return ragged_paged_attention_ref(tq, local, tqs, tkl,
                                      page_slice=page_slice, **kw)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("window,softcap", [(None, None), (6, 2.0)],
                         ids=["plain", "window+softcap"])
def test_sliced_attention_merged_matches_jax_kernel(quantized, k, window,
                                                    softcap):
    rng = np.random.default_rng(10 + k)
    q, cache, q_start, n_new = make_ragged_case(
        rng, quantized=quantized, gqa=2, lanes=MIXED)
    want = np.asarray(jax_rpa(q, cache, q_start, q_start + n_new, n_kv=2,
                              head_dim=16, window=window,
                              attn_softcap=softcap, interpret=True))
    tc = arena_from_numpy(jax_tree_to_numpy(cache), device="cpu")
    tq = torch.tensor(np.asarray(q))
    tqs = torch.tensor(np.asarray(q_start))
    tkl = tqs + torch.tensor(np.asarray(n_new))
    kw = dict(n_kv=2, head_dim=16, window=window, attn_softcap=softcap)
    n_pages = tc["k_pages"].shape[0]
    for slices in (_slices(n_pages, k), [(0, 1), (1, n_pages - 1)]):
        parts = [_sliced(tq, tc, tqs, tkl, sl, **kw) for sl in slices]
        got = merge_slices(parts).numpy()
        valid = np.arange(q.shape[1])[None, :] < np.asarray(n_new)[:, None]
        np.testing.assert_allclose(got[valid], want[valid], atol=1e-5,
                                   rtol=1e-5)
        assert (got[~valid] == 0).all()
    # the null page alone: no live page in the slice, every row empty
    o, m, l = parts[0]
    assert (o == 0).all() and (m == -1e30).all() and (l == 0).all()


def test_span_plan_over_slices_sums_to_the_unsliced_plan():
    """A sliced call's spans are chunks of the runs of a lane's live
    entries in its slice: over any cut of the arena the slices' spans hold
    every live page once, and a span never holds more than its width."""
    rng = np.random.default_rng(5)
    _, cache, q_start, n_new = make_ragged_case(rng, lanes=MIXED)
    tbl = np.asarray(cache["block_tbl"])
    qs, kl = np.asarray(q_start), np.asarray(q_start + n_new)
    n_pages = int(np.asarray(cache["k_pages"]).shape[0])
    s, page = int(np.asarray(n_new).max()), 8

    def pages(plan):
        return sorted((b, qb, p) for b, lane in enumerate(plan)
                      for qb, spans in enumerate(lane)
                      for p0, p1 in spans for p in range(p0, p1))
    whole = pages(span_plan(qs, kl, s, page, 2, q_block=4))
    for k in (2, 4):
        plans = [span_plan(qs, kl, s, page, 2, q_block=4, tbl=tbl,
                           page_slice=sl) for sl in _slices(n_pages, k)]
        assert sorted(sum((pages(p) for p in plans), [])) == whole
        for plan in plans:
            for lane in plan:
                for spans in lane:
                    assert all(0 < p1 - p0 <= 2 for p0, p1 in spans)
    runs = slice_runs([5, 6, 1, 7, 9, 2], 6, (5, 4))
    assert runs == [(0, 2), (3, 4)]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_bridge_gives_each_rank_its_part(shape):
    """``params_from_numpy(mesh=)`` and ``arena_from_numpy(mesh=)`` on JAX's
    trees: rank (d, m) gets shard m of the [G, S] stream stacks and the
    slices of the dense leaves and of the arena (with the sink page when
    D > 1), as ``shard_params`` and ``shard_arena`` give them."""
    tree = jax_tree_to_numpy(_jax_tq()[1])
    whole = params_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(4)
    arena_np = {"b0": {"attn": {
        "k_pages": rng.standard_normal((2, 16, 8, 32)).astype(np.float32),
        "block_tbl": np.zeros((2, 4, 4), np.int32)}}}
    for rk in _ranks(shape):
        got = params_from_numpy(tree, device="cpu", mesh=rk)
        want = shd.shard_params(whole, rk)
        for (path, a), (_, b) in zip(_stream_leaves(got),
                                     _stream_leaves(want)):
            if isinstance(a, ShardedQTensor):
                assert list(a.held) == [rk.index("model")], path
                for f in QT_FIELDS:
                    assert torch.equal(getattr(a, f), getattr(b, f)), path
            elif isinstance(a, torch.Tensor):
                assert torch.equal(a, b), path
        arena = arena_from_numpy(arena_np, device="cpu", mesh=rk)
        local = shd.shard_arena(arena_from_numpy(arena_np, device="cpu"),
                                rk)
        assert torch.equal(arena["b0"]["attn"]["k_pages"],
                           local["b0"]["attn"]["k_pages"])
