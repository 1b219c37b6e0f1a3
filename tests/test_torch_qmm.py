"""The port's qmm dispatch (``repro_torch.kernels.ops``) and the plain
qmm against the JAX package's ``kernels/ops.py:qmm`` (Pallas in
interpret mode) and ``qmm_ref``, on the same streams and inputs.

Tolerances: fp32 atol/rtol 1e-5 (the same fp32 products summed in another
order); bf16 2e-2 (the result is rounded to bf16 on both sides, after
sums in another order — an ulp of bf16 is 2^-8 of the value)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qconfig import QMCConfig as JaxQMCConfig
from repro.core.qtensor import quantize_qtensor as jax_quantize
from repro.kernels import ops as jax_ops
from repro.kernels.ref import qmm_ref as jax_qmm_ref
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import ops as kops
from repro_torch.kernels import qmm as kqmm
from repro_torch.kernels.qmm import (DECODE_MAX_ROWS, colstrip_splits,
                                     decode_counters, decode_splits)
from repro_torch.kernels.ref import qmm_ref
from test_torch_bridge import jax_tree_to_numpy

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _streams(k, n, seed=0):
    w = np.random.default_rng(seed).standard_t(3.0, size=(k, n))
    jq = jax_quantize(jnp.asarray(w.astype(np.float32)),
                      JaxQMCConfig(rho=0.3, granularity="subtile"))
    return jq, params_from_numpy({"w": jax_tree_to_numpy(jq)},
                                 device="cpu")["w"]


@pytest.fixture(scope="module")
def streams_128x256():
    return _streams(128, 256)


def _x(m, k, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)
    jdt, tdt = DT[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("m,k,n,subtile", [
    (m, k, n, st) for m in (1, 3, 7, 8, 16, 120, 128, 130, 256, 384)
    for k, n in ((128, 256), (128, 384), (256, 512), (120, 256))
    for st in ((8, 128), (8, 32))])
def test_plan_matches_jax_pallas_plan(m, k, n, subtile):
    want = jax_ops.qmm_plan(m, k, n, subtile, use_pallas=True)
    got = kops.qmm_plan(m, k, n, subtile)
    if want["path"] == "skinny_xla":       # never on the Pallas route
        pytest.fail("JAX's Pallas plan chose the XLA path")
    assert got == {"path": want["path"], "pad_m": want["pad_m"]}
    assert kops.qmm_plan(m, k, n, subtile, use_kernels=False)["path"] == \
        "ref"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3, 4, 7, 8])
def test_decode_width_qmm_matches_jax(m, dtype, streams_128x256):
    jq, pq = streams_128x256
    jx, tx = _x(m, 128, dtype)
    kops.reset_path_counts()
    got = kops.qmm(tx, pq)
    assert kops.path_counts == {"decode": 1, "colstrip": 0, "ref": 0}
    assert got.shape == (m, 256) and got.dtype == DT[dtype][1]
    _close(got, jax_ops.qmm(jx, jq, use_pallas=True), dtype)
    _close(got, jax_qmm_ref(jx, jq), dtype)


@pytest.mark.parametrize("k,n", [(128, 256), (256, 128), (128, 512)])
def test_colstrip_qmm_matches_jax(k, n):
    jq, pq = _streams(k, n, seed=k + n)
    jx, tx = _x(128, k, "float32")
    kops.reset_path_counts()
    got = kops.qmm(tx, pq)
    assert kops.path_counts["colstrip"] == 1
    _close(got, jax_ops.qmm(jx, jq, use_pallas=True), "float32")


def test_batch_dims_and_plain_path(streams_128x256):
    jq, pq = streams_128x256
    jx, tx = _x(6, 128, "float32")
    got = kops.qmm(tx.reshape(2, 3, 128), pq)
    assert got.shape == (2, 3, 256)
    kops.reset_path_counts()
    plain = kops.qmm(tx, pq, use_kernels=False)
    assert kops.path_counts == {"decode": 0, "colstrip": 0, "ref": 1}
    _close(got.reshape(6, 256), jax_qmm_ref(jx, jq), "float32")
    assert torch.equal(plain, qmm_ref(tx, pq))


@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (8, 2048, 100352),
                                   (8, 5632, 2048), (64, 128, 256),
                                   (64, 2048, 5632), (120, 5632, 2048),
                                   (8, 5632, 100352), (8, 8192, 100352)])
def test_decode_split_covers_every_subtile_row(m, k, n):
    """Every subtile row in exactly one split, >= 8 rows a split, and no
    more than DECODE_MAX_ROWS (the x slice a block stages in shared
    memory): K = 5632 and 8192 at the lm_head's width split for that
    alone."""
    splits, rows = decode_splits(m, k, n)
    gr = k // 8
    assert splits * rows >= gr > (splits - 1) * rows
    assert rows >= 8 or splits == 1
    assert rows <= DECODE_MAX_ROWS
    if n == 100352:
        assert splits == -(-gr // DECODE_MAX_ROWS)


def test_decode_counters_grow_and_stay_cached(monkeypatch):
    """One zeroed ticket buffer per (device, stream): reused while large
    enough, replaced by a larger zeroed one when a grid needs more."""
    monkeypatch.setattr(kqmm, "_counters", {})
    cpu = torch.device("cpu")
    a = decode_counters(cpu, 7, 44)
    assert a.dtype == torch.int32 and a.numel() == 44 and not a.any()
    assert decode_counters(cpu, 7, 16) is a
    b = decode_counters(cpu, 7, 784)
    assert b is not a and b.numel() == 784 and not b.any()
    assert decode_counters(cpu, 8, 16) is not b       # another stream
    assert len(kqmm._counters) == 2


@pytest.mark.parametrize("m,k,n", [(128, 2048, 2048), (128, 5632, 2048),
                                   (512, 2048, 5632), (1024, 2048, 100352),
                                   (128, 128, 256)])
def test_colstrip_split_covers_every_k_step(m, k, n):
    splits, rows = colstrip_splits(m, k, n)
    assert rows % 32 == 0
    assert splits * rows >= k > (splits - 1) * rows
    assert rows >= 256 or splits == 1
