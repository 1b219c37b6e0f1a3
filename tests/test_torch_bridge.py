"""The numpy bridge between the JAX package and the PyTorch port.

``jax_tree_to_numpy`` is the test-side half: it flattens a JAX parameter
or arena tree into nested dicts of numpy arrays (QTensor and one-shard
ShardedQTensor leaves become dicts of their fields, with the int4 inlier
container widened to int8 first — numpy has no int4). The other port
tests import it from here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core.qconfig import QMCConfig as JaxQMCConfig
from repro.core.qtensor import QTensor as JaxQTensor
from repro.core.qtensor import dequantize_qtensor as jax_dequantize
from repro.core.qtensor_sharded import ShardedQTensor
from repro.core.serving_quant import quantize_for_serving as jax_q4s
from repro.models import kvcache as jax_kv
from repro.models.model import init_params as jax_init_params
from repro_torch.bridge import (arena_from_numpy, arena_to_numpy,
                                params_from_numpy)
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import QTensor, dequantize_qtensor
from repro_torch.core.serving_quant import quantize_for_serving

QT_FIELDS = ("in_codes", "out_codes", "stream_pos", "is_out", "scale_in",
             "scale_out")

# The suite runs under pytest-xdist with several workers per host; torch's
# default of one intra-op thread per core in every worker oversubscribes
# the cores (the port's tests ran about twice as long). Every parity test
# imports this module.
torch.set_num_threads(1)


def jax_tree_to_numpy(tree):
    """Nested dicts of numpy arrays from a JAX tree (see module doc)."""
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (JaxQTensor, ShardedQTensor)):
        fields = {f: np.asarray(getattr(tree, f).astype(jnp.int8)
                                if f == "in_codes" else getattr(tree, f))
                  for f in QT_FIELDS}
        if isinstance(tree, ShardedQTensor):
            if tree.n_shards != 1:
                raise ValueError("only one-shard ShardedQTensors cross over")
            if fields["in_codes"].ndim == 4:       # unstacked [1, k, r, c]
                fields = {f: v[0] for f, v in fields.items()}
        fields.update(shape=tuple(tree.shape), bits_in=tree.bits_in,
                      bits_out=tree.bits_out, subtile=tuple(tree.subtile))
        return fields
    arr = np.asarray(tree)
    if arr.dtype == jnp.bfloat16:
        arr = arr.astype(np.float32)
    return arr


def port_params_to_jax(tree):
    """A port parameter tree as a JAX tree: QTensors become JAX QTensors
    (per-group lists stack their fields over [G]), tensors jnp arrays —
    so the JAX package can serve the port's own QMC streams."""
    if isinstance(tree, dict):
        return {k: port_params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return JaxQTensor(*(jnp.asarray(getattr(tree, f).numpy())
                            for f in QT_FIELDS), shape=tree.shape,
                          bits_in=tree.bits_in, bits_out=tree.bits_out,
                          subtile=tree.subtile)
    if isinstance(tree, list):
        qts = [port_params_to_jax(q) for q in tree]
        return jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *qts)
    return jnp.asarray(tree.numpy())


def test_sharded_one_shard_leaves_cross_over():
    """quantize_for_serving's one-shard ShardedQTensors — stacked [G, 1,
    ...] and unstacked [1, ...] — with int4 inlier containers."""
    rng = np.random.default_rng(0)
    tree = {"blocks": {"w_up": jnp.asarray(
        rng.standard_normal((2, 16, 256)).astype(np.float32))},
        "lm_head": jnp.asarray(rng.standard_normal((16, 256))
                               .astype(np.float32))}
    jq = jax_q4s(tree, JaxQMCConfig(rho=0.3, granularity="subtile"),
                 min_dim=16)
    assert isinstance(jq["lm_head"], ShardedQTensor)
    assert jq["lm_head"].in_codes.dtype == jnp.int4
    port = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    assert isinstance(port["lm_head"], QTensor)
    assert [type(q) for q in port["blocks"]["w_up"]] == [QTensor] * 2
    np.testing.assert_array_equal(
        dequantize_qtensor(port["lm_head"], torch.float32).numpy(),
        np.asarray(jax_dequantize(jq["lm_head"].local(0), jnp.float32)))
    for g in range(2):
        local = jax.tree_util.tree_map(lambda l: l[g],
                                       jq["blocks"]["w_up"]).local(0)
        np.testing.assert_array_equal(
            dequantize_qtensor(port["blocks"]["w_up"][g],
                               torch.float32).numpy(),
            np.asarray(jax_dequantize(local, jnp.float32)))


def test_plain_qtensor_leaves_cross_over():
    """An unstacked JAX QTensor and a [G]-stacked one."""
    from repro.core.qtensor import quantize_qtensor as jax_quantize
    cfg = JaxQMCConfig(rho=0.3, granularity="subtile")
    w = jax.random.normal(jax.random.PRNGKey(3), (2, 16, 256))
    q0 = jax_quantize(w[0], cfg)
    q1 = jax_quantize(w[1], cfg)
    stacked = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), q0, q1)
    port = params_from_numpy(jax_tree_to_numpy(
        {"one": q0, "two": stacked}), device="cpu")
    assert isinstance(port["one"], QTensor)
    assert len(port["two"]) == 2
    np.testing.assert_array_equal(port["two"][1].stream_pos.numpy(),
                                  np.asarray(q1.stream_pos))


def test_params_round_trip():
    """JAX dense params -> port -> port PTQ -> JAX -> port: every leaf
    arrives unchanged, and both packages dequantize the streams alike."""
    cfg = jax_reduced_config("stablelm-1.6b")
    dense = jax_init_params(cfg, jax.random.PRNGKey(0))
    port = params_from_numpy(jax_tree_to_numpy(dense), device="cpu")
    np.testing.assert_array_equal(port["embed"]["tok"].numpy(),
                                  np.asarray(dense["embed"]["tok"]))
    qport = quantize_for_serving(port, QMCConfig(rho=0.3,
                                                 granularity="subtile"),
                                 min_dim=64)
    attn = qport["blocks"]["b0"]["attn"]
    assert isinstance(attn["wq"], list) and len(attn["wq"]) == cfg.n_groups
    # [128, 64] wk/wv cannot tile (8, 128): they stay dense [G, 128, 64]
    assert tuple(attn["wk"].shape) == (cfg.n_groups, 128, 64)
    jq = port_params_to_jax(qport)
    back = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    for g in range(cfg.n_groups):
        for f in QT_FIELDS:
            assert torch.equal(getattr(back["blocks"]["b0"]["attn"]["wq"][g],
                                       f), getattr(attn["wq"][g], f))
    np.testing.assert_array_equal(
        dequantize_qtensor(qport["lm_head"], torch.float32).numpy(),
        np.asarray(jax_dequantize(jq["lm_head"], jnp.float32)))
    assert torch.equal(back["blocks"]["b0"]["attn"]["bq"],
                       attn["bq"])


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_arena_round_trip(quant):
    cfg = dataclasses.replace(jax_reduced_config("stablelm-1.6b"),
                              kv_cache_quant=quant)
    arena = jax_kv.paged_init_cache(cfg, 5, 16, 2, 3, jnp.float32)
    rng = np.random.default_rng(0)

    def fill(leaf):
        x = rng.standard_normal(leaf.shape) * 50
        return jnp.asarray(x).astype(leaf.dtype)
    arena = jax.tree_util.tree_map(fill, arena)
    flat = jax_tree_to_numpy(arena)
    port = arena_from_numpy(flat, device="cpu")
    attn = port["b0"]["attn"]
    if quant:
        assert attn["k_scale_pages"].dtype == torch.bfloat16
        assert attn["k_pages"].dtype == torch.int8
    back = arena_to_numpy(port)
    for name, leaf in flat["b0"]["attn"].items():
        np.testing.assert_array_equal(back["b0"]["attn"][name], leaf)
