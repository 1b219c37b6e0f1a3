"""``optim/grad_compress.py`` and ``ft/elastic.py`` of the port against the
JAX package's: int8 codes, scales, dequantized values and error-feedback
residuals equal exactly (both round half to even), over sizes that pad
and sizes that do not; the error-feedback descent case of
``tests/test_optim.py``; ``choose_mesh_shape`` equal to JAX's over the
cases of ``tests/test_checkpoint_ft.py`` and over two pods; and
``make_elastic_mesh`` over a gloo world of 5 ranks, the fifth leaving
the grid."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.ft.elastic import choose_mesh_shape as jax_choose
from repro.optim import grad_compress as jgc
from repro_torch import tree as T
from repro_torch.ft import elastic
from repro_torch.launch.mesh import spawn
from repro_torch.optim import grad_compress as pgc

SIZES = [(2048,), (4096,), (5,), (3, 700), (2, 2048, 3), (64, 33)]


def _grads(seed: int):
    rng = np.random.default_rng(seed)
    out = {}
    for i, shape in enumerate(SIZES):
        g = rng.standard_normal(shape).astype(np.float32)
        g.reshape(-1)[:3] = [0.0, 1e-30, -5e4]          # extremes
        out[f"g{i}"] = g
    # exact halves of a scale: round half to even decides the code
    out["ties"] = (np.arange(-8, 9, dtype=np.float32) + 0.5) * (3.0 / 127)
    out["ties"][-1] = 3.0                                 # the max: scale
    out["zeros"] = np.zeros((40,), np.float32)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_decompress_equal_jax_exactly(seed):
    g = _grads(seed)
    e = {k: (np.random.default_rng(seed + 7).standard_normal(v.shape)
             * 1e-2).astype(np.float32) for k, v in g.items()}
    jq, je = jgc.compress({k: jnp.asarray(v) for k, v in g.items()},
                          {k: jnp.asarray(v) for k, v in e.items()})
    pq, pe = pgc.compress({k: torch.from_numpy(v) for k, v in g.items()},
                          {k: torch.from_numpy(v) for k, v in e.items()})
    for k in g:
        assert pq[k]["q"].dtype == torch.int8
        np.testing.assert_array_equal(pq[k]["q"].numpy(),
                                      np.asarray(jq[k]["q"]))
        np.testing.assert_array_equal(pq[k]["scale"].numpy(),
                                      np.asarray(jq[k]["scale"]))
        np.testing.assert_array_equal(pe[k].numpy(), np.asarray(je[k]))
    jd = jgc.decompress(jq, {k: jnp.asarray(v) for k, v in g.items()})
    pd = pgc.decompress(pq, {k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        assert tuple(pd[k].shape) == g[k].shape
        np.testing.assert_array_equal(pd[k].numpy(), np.asarray(jd[k]))


def test_compress_keeps_tree_order_and_init_error():
    """A dict whose keys are not sorted, nested: ``decompress`` puts each
    leaf back where it came from; ``init_error`` is fp32 zeros."""
    g = {"z": torch.ones(3, 5) * 2.0, "a": {"y": torch.arange(7.0),
                                            "b": torch.full((4,), -1.0)}}
    err = pgc.init_error(g)
    assert all(t.dtype == torch.float32 and not t.any()
               for t in T.leaves(err))
    q, _ = pgc.compress(g, err)
    d = pgc.decompress(q, g)
    assert list(d) == ["z", "a"] and list(d["a"]) == ["y", "b"]
    for a, b in zip(T.leaves(d), T.leaves(g)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=float(
            b.abs().max()) / 127 * 0.51)


def test_error_feedback_convergence():
    """``tests/test_optim.py``'s case on the port: compressed descent with
    error feedback tracks exact descent (two "pods" with opposite
    minibatch noise)."""
    target = torch.from_numpy(np.random.default_rng(0).normal(size=64)
                              .astype(np.float32))

    def grad(w):
        return w - target
    w_exact = torch.zeros(64)
    w_comp = torch.zeros(64)
    err = {"w": torch.zeros(64)}
    lr = 0.1
    for i in range(150):
        w_exact = w_exact - lr * grad(w_exact)
        g1 = grad(w_comp) + 0.01 * np.sin(i)
        g2 = grad(w_comp) - 0.01 * np.sin(i)
        q1, e1 = pgc.compress({"w": g1}, {"w": err["w"]})
        q2, _ = pgc.compress({"w": g2}, {"w": torch.zeros(64)})
        g_avg = 0.5 * (pgc.decompress(q1, {"w": g1})["w"]
                       + pgc.decompress(q2, {"w": g2})["w"])
        err = e1
        w_comp = w_comp - lr * g_avg
    assert float(0.5 * ((w_comp - target) ** 2).sum()) < 1e-4
    assert float((w_comp - w_exact).abs().max()) < 1e-2


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("n", [512, 256, 128, 24, 6, 7, 5, 2, 1])
@pytest.mark.parametrize("want_tp", [16, 4, 1])
def test_choose_mesh_shape_equals_jax(n, want_tp, pods):
    assert elastic.choose_mesh_shape(n, want_tp=want_tp, pods=pods) == \
        jax_choose(n, want_tp=want_tp, pods=pods)
    assert elastic.PREFERRED_TP == (16, 8, 4, 2, 1)


def _elastic_rank(mesh):
    """On a 1-D world of 5: the elastic (pod 2, data 1, model 2) grid over
    ranks 0-3, a SUM over its model lines and over all of it."""
    em = elastic.make_elastic_mesh(want_tp=2, pods=2, backend="gloo")
    if em is None:
        return dist.get_rank(), None
    t = torch.tensor([float(em.rank + 1)])
    em.all_reduce(t, "model")
    s = torch.tensor([1.0])
    em.all_reduce(s, "all")
    return dist.get_rank(), (em.shape, em.axis_names, em.coords,
                             t.item(), s.item())


def test_make_elastic_mesh_drops_ranks_past_the_grid():
    got = dict(spawn(_elastic_rank, (5,), backend="gloo", timeout_s=120))
    assert got[4] is None
    for r in range(4):
        shape, axes, coords, model_sum, total = got[r]
        assert shape == (2, 1, 2) and axes == ("pod", "data", "model")
        assert coords == {"pod": r // 2, "data": 0, "model": r % 2}
        assert model_sum == (3.0 if r < 2 else 7.0)
        assert total == 4.0
