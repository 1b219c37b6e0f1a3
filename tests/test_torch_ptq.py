"""The port's PTQ entry point (``repro_torch.core``: quantizers, partition,
noise, qmc, mx, qtensor byte counts, apply) and its cache-less forward
against the JAX package's, on the same numpy inputs on the CPU.

Tolerances, with their reasons:
- quantizers: rtol 1e-6 (the same float32 ops; sums in another order);
- masks: equal (a sort, and the quantile in ``jnp.quantile``'s float32
  arithmetic);
- qmc scales rtol 1e-5, codes equal on >= 99.9% of entries, ``w_hat``
  rtol 1e-5 where the codes agree: the two libraries may round an alpha
  grid point or a per-channel loss differently in its last bit, so a
  near-tie between grid points may flip a channel's choice (ROADMAP C);
- mx and rtn fake-quant: equal (elementwise float32 ops);
- noise: the draws cannot match (``jax.random`` vs ``torch.Generator``),
  so flip rates are held to within 5 sigma of (p_minus, p_plus);
- logits: atol/rtol 1e-4 (fp32 both sides, sums in other orders through
  2 layers and a 512-way head).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.core import apply as jax_apply
from repro.core import noise as jax_noise
from repro.core import partition as jax_part
from repro.core import quantizers as jax_q
from repro.core.mx import mx_fake_quant as jax_mx
from repro.core.qconfig import MXConfig as JaxMXConfig
from repro.core.qconfig import NoiseModel as JaxNoiseModel
from repro.core.qconfig import QMCConfig as JaxQMCConfig
from repro.core.qmc import qmc_quantize as jax_qmc_quantize
from repro.core.qtensor import quantize_qtensor as jax_quantize_qtensor
from repro.models.model import forward as jax_forward
from repro.models.model import init_params as jax_init
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config
from repro_torch.core import apply, noise, partition, quantizers
from repro_torch.core.mx import mx_fake_quant
from repro_torch.core.qconfig import MXConfig, NoiseModel, QMCConfig
from repro_torch.core.qmc import qmc_quantize, quantization_mse
from repro_torch.core.qtensor import QTensor, quantize_qtensor
from repro_torch.models.model import forward
from test_torch_bridge import jax_tree_to_numpy

NOISE = dict(cell_bits=3, p_minus=0.015, p_plus=0.015)


def _heavy(shape, seed):
    return np.random.default_rng(seed).standard_t(3.0, size=shape).astype(
        np.float32)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("bits", [3, 4, 5])
def test_minmax_and_rtn_match_jax(bits, axis):
    w = _heavy((96, 256), bits)
    want_s = _np(jax_q.minmax_scale(jnp.asarray(w), bits, channel_axis=axis))
    got_s = quantizers.minmax_scale(torch.from_numpy(w), bits,
                                    channel_axis=axis).numpy()
    assert got_s.shape == want_s.shape
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)
    want = _np(jax_q.rtn_quantize(jnp.asarray(w), bits, channel_axis=axis))
    got = quantizers.rtn_quantize(torch.from_numpy(w), bits,
                                  channel_axis=axis).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("axis", [0, -1])
def test_scale_searches_and_expected_noise_mse_match_jax(axis):
    w = _heavy((128, 256), 7)
    mask = np.abs(w) > 1.0
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    for want, got in (
            (jax_q.noise_aware_scale_search(
                jw, 3, JaxNoiseModel(**NOISE), channel_axis=axis,
                mask=jnp.asarray(~mask)),
             quantizers.noise_aware_scale_search(
                tw, 3, NoiseModel(**NOISE), channel_axis=axis,
                mask=torch.from_numpy(~mask))),
            (jax_q.mse_scale_search(jw, 5, channel_axis=axis,
                                    mask=jnp.asarray(mask)),
             quantizers.mse_scale_search(tw, 5, channel_axis=axis,
                                         mask=torch.from_numpy(mask)))):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5)
    # a float32 sum in two orders: kept to 8192 terms for rtol 1e-6
    jw, tw = jw[:64, :128], tw[:64, :128]
    s = quantizers.minmax_scale(tw, 3, channel_axis=axis)
    want = jax_q.expected_noise_mse(jw, jnp.asarray(s.numpy()), 3,
                                    JaxNoiseModel(**NOISE))
    got = quantizers.expected_noise_mse(tw, s, 3, NoiseModel(**NOISE))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------
def _mask_case(name):
    rng = np.random.default_rng(3)
    if name == "student-t":
        return _heavy((192, 384), 4)
    if name == "ties":          # few distinct values: tau lands on a tie
        return rng.integers(-3, 4, size=(64, 256)).astype(np.float32)
    # flat, just above 2^24 elements: past torch.quantile's limit, and
    # n - 1 is not a float32
    return _heavy(((1 << 24) + 8,), 5)


@pytest.mark.parametrize("case", ["student-t", "ties", "flat-2^24"])
def test_scalar_outlier_mask_matches_jax(case):
    w = _mask_case(case)
    for rho in ((0.3,) if case.startswith("flat") else (0.05, 0.3, 0.5)):
        want = _np(jax_part.scalar_outlier_mask(jnp.asarray(w), rho))
        got = partition.scalar_outlier_mask(torch.from_numpy(w), rho)
        np.testing.assert_array_equal(got.numpy(), want)


def test_partition_matches_jax_and_sums_back():
    w = _heavy((64, 256), 8)
    for gran in ("scalar", "subtile"):
        w_in, w_out = partition.partition(torch.from_numpy(w), 0.3, gran)
        j_in, j_out = jax_part.partition(jnp.asarray(w), 0.3, gran)
        np.testing.assert_array_equal(w_in.numpy(), _np(j_in))
        np.testing.assert_array_equal(w_out.numpy(), _np(j_out))
        np.testing.assert_array_equal((w_in + w_out).numpy(), w)
    with pytest.raises(ValueError):
        partition.partition(torch.from_numpy(w), 0.3, "row")


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gran", ["scalar", "subtile"])
@pytest.mark.parametrize("shape,seed", [((256, 512), 0), ((1024, 2048), 1)])
def test_qmc_quantize_matches_jax(shape, seed, gran):
    w = _heavy(shape, seed)
    want = jax_qmc_quantize(jnp.asarray(w),
                            JaxQMCConfig(rho=0.3, granularity=gran))
    got = qmc_quantize(torch.from_numpy(w), QMCConfig(rho=0.3,
                                                       granularity=gran))
    np.testing.assert_array_equal(got.outlier_mask.numpy(),
                                  _np(want.outlier_mask))
    for f in ("scale_in", "scale_out"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   _np(getattr(want, f)), rtol=1e-5)
    agree = np.ones(shape, bool)
    for f in ("codes_in", "codes_out"):
        eq = getattr(got, f).numpy() == _np(getattr(want, f))
        assert eq.mean() >= 0.999, f
        agree &= eq
    np.testing.assert_allclose(got.w_hat.numpy()[agree],
                               _np(want.w_hat)[agree], rtol=1e-5)
    mse = float(quantization_mse(torch.from_numpy(w), got.w_hat))
    assert mse < float(np.mean(w ** 2))


def test_qmc_subtile_falls_back_to_scalar_on_untileable_shapes():
    w = _heavy((100, 256), 9)                    # 100 rows: no (8, 128)
    got = qmc_quantize(torch.from_numpy(w), QMCConfig(granularity="subtile"))
    want = partition.scalar_outlier_mask(torch.from_numpy(w), 0.3)
    assert torch.equal(got.outlier_mask, want)


# ---------------------------------------------------------------------------
# ReRAM noise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [2, 3])
def test_confusion_matrix_and_ber_match_jax(bits):
    nm = NoiseModel.for_mode(bits)
    jm = JaxNoiseModel.for_mode(bits)
    np.testing.assert_array_equal(noise.confusion_matrix(bits, nm).numpy(),
                                  _np(jax_noise.confusion_matrix(bits, jm)))
    assert noise.ber_from_confusion(bits, nm) == \
        jax_noise.ber_from_confusion(bits, jm)


def test_perturb_codes_flip_rates_and_boundaries():
    nm = NoiseModel(cell_bits=3, p_minus=0.02, p_plus=0.03)
    n = 1 << 20
    codes = torch.zeros(n)                        # an interior state
    gen = torch.Generator()
    gen.manual_seed(0)
    d = (noise.perturb_codes(gen, codes, 3, nm) - codes).numpy()
    assert set(np.unique(d)) <= {-1.0, 0.0, 1.0}
    for p, got in ((nm.p_minus, (d == -1).mean()), (nm.p_plus,
                                                    (d == 1).mean())):
        assert abs(got - p) <= 5 * np.sqrt(p * (1 - p) / n)
    # boundary states fold inward: -4 never reads lower, 3 never higher
    lo = noise.perturb_codes(gen, torch.full((n,), -4.0), 3, nm)
    hi = noise.perturb_codes(gen, torch.full((n,), 3.0), 3, nm)
    assert lo.min() == -4 and set(lo.unique().tolist()) == {-4.0, -3.0}
    assert hi.max() == 3 and set(hi.unique().tolist()) == {2.0, 3.0}
    # the same seed gives the same draws
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    assert torch.equal(noise.perturb_codes(g1, codes[:4096], 3, nm),
                       noise.perturb_codes(g2, codes[:4096], 3, nm))


def test_perturb_weights_moves_by_at_most_one_step():
    w = torch.from_numpy(_heavy((64, 128), 10))
    s = quantizers.minmax_scale(w, 3)
    w_deq = quantizers.fake_quant(w, s, 3)
    gen = torch.Generator()
    gen.manual_seed(1)
    noisy = noise.perturb_weights(gen, w_deq, s, 3, NoiseModel.for_mode(3))
    steps = torch.round((noisy - w_deq) / s)
    assert set(steps.unique().tolist()) <= {-1.0, 0.0, 1.0}
    assert (steps != 0).any()


# ---------------------------------------------------------------------------
# MXINT4
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,axis", [((128, 96), 0), ((100, 64), 0),
                                        ((64, 70), -1), ((2, 40, 16), 1)])
def test_mx_fake_quant_matches_jax(shape, axis):
    w = _heavy(shape, 11)
    want = jax_mx(jnp.asarray(w), JaxMXConfig(block_axis=axis))
    got = mx_fake_quant(torch.from_numpy(w), MXConfig(block_axis=axis))
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), _np(want))


# ---------------------------------------------------------------------------
# QTensor byte counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,rho", [((64, 256), 0.3), ((32, 384), 0.1)])
def test_qtensor_byte_counts_match_jax(shape, rho):
    w = _heavy(shape, 12)
    jq = jax_quantize_qtensor(jnp.asarray(w), JaxQMCConfig(
        rho=rho, granularity="subtile"), use_int4=False)
    pq = quantize_qtensor(torch.from_numpy(w), QMCConfig(
        rho=rho, granularity="subtile"))
    assert pq.nbytes_packed() == jq.nbytes_packed()
    assert pq.nbytes_container() == jq.nbytes_container()


# ---------------------------------------------------------------------------
# quantize_model over the reduced stablelm-1.6b tree
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reduced():
    jcfg = jax_reduced("stablelm-1.6b")
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    return jcfg, jparams, pparams


@pytest.fixture(scope="module")
def jax_quantized(reduced):
    """The reference's quantize_model per method, run once per module (it
    runs eagerly, as its callers do, and takes seconds a method)."""
    cache = {}

    def get(method):
        if method not in cache:
            cache[method] = jax_apply.quantize_model(
                reduced[1], method, qmc=JaxQMCConfig(rho=0.3), min_dim=64,
                use_int4=False)
        return cache[method]
    return get


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _assert_leaf_close(got, want, method):
    if method == "qtensor":
        np.testing.assert_array_equal(got.is_out.numpy(), _np(want.is_out))
        np.testing.assert_array_equal(got.stream_pos.numpy(),
                                      _np(want.stream_pos))
        for f in ("scale_in", "scale_out"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       _np(getattr(want, f)), rtol=1e-5)
        for f in ("in_codes", "out_codes"):
            eq = getattr(got, f).numpy() == _np(
                getattr(want, f).astype(jnp.int8))
            assert eq.mean() >= 0.999
        return
    got, want = got.numpy(), _np(want)
    if method in ("rtn4", "mx4"):
        np.testing.assert_array_equal(got, want)
        return
    # qmc: a channel whose grid choice flipped on a near-tie differs
    close = np.isclose(got, want, rtol=1e-5, atol=0)
    assert close.mean() >= 0.999


@pytest.mark.parametrize("method", ["fp16", "rtn4", "mx4", "qmc",
                                    "qmc_subtile", "qtensor"])
def test_quantize_model_matches_jax(reduced, jax_quantized, method):
    _, jparams, pparams = reduced
    jq = jax_quantized(method)
    pq = apply.quantize_model(pparams, method, qmc=QMCConfig(rho=0.3),
                              min_dim=64)
    j_in, p_in = dict(_flat(jparams)), dict(_flat(pparams))
    j_out, p_out = dict(_flat(jq)), dict(_flat(pq))
    assert j_out.keys() == p_out.keys()
    j_done = {k for k in j_out if j_out[k] is not j_in[k]}
    p_done = {k for k in p_out if p_out[k] is not p_in[k]}
    assert p_done == j_done
    if method == "fp16":
        assert pq is pparams and not p_done
    else:
        assert p_done and "embed/tok" not in p_done
    for k in p_done:
        assert isinstance(p_out[k], QTensor) == (method == "qtensor")
        _assert_leaf_close(p_out[k], j_out[k], method)
    assert apply.model_bits_per_weight(pparams, method, QMCConfig(rho=0.3)) \
        == jax_apply.model_bits_per_weight(jparams, method,
                                           JaxQMCConfig(rho=0.3))


def test_quantize_model_noise_draws_are_shared_across_groups(reduced):
    """One generator state per leaf, restored for every group (the
    reference's one key per leaf); other leaves draw anew."""
    _, _, pparams = reduced
    w = pparams["blocks"]["b0"]["ffn"]["w_up"]
    twin = {"a": torch.stack([w[0], w[0]]), "b": torch.stack([w[0], w[0]])}
    gen = torch.Generator()
    gen.manual_seed(3)
    q = apply.quantize_model(twin, "qmc", qmc=QMCConfig(rho=0.3),
                             noise_gen=gen)
    clean = apply.quantize_model(twin, "qmc", qmc=QMCConfig(rho=0.3))
    assert torch.equal(q["a"][0], q["a"][1])
    assert not torch.equal(q["a"][0], clean["a"][0])
    assert not torch.equal(q["a"][0], q["b"][0])


def test_quantize_model_refuses_unported_methods(reduced):
    for method in ("gptq", "awq"):
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            apply.quantize_model(reduced[2], method)
    with pytest.raises(ValueError):
        apply.quantize_model(reduced[2], "int3")


# ---------------------------------------------------------------------------
# the cache-less forward
# ---------------------------------------------------------------------------
def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _logits_pair(jcfg, pcfg, jparams, toks):
    want, _, _ = jax_forward(jcfg, jparams, jnp.asarray(toks))
    pparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    got = forward(pcfg, pparams, torch.from_numpy(toks).long())
    return got.numpy(), _np(want)


@pytest.mark.parametrize("weights", ["dense", "qmc"])
def test_cacheless_forward_matches_jax(reduced, jax_quantized, weights):
    jcfg, jparams, _ = reduced
    if weights == "qmc":
        jparams = jax_quantized("qmc")
    got, want = _logits_pair(jcfg, reduced_config("stablelm-1.6b"),
                             jparams, _tokens(jcfg, 2, 24))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s", [48, 40])
def test_chunked_cacheless_forward_matches_jax(reduced, s):
    jcfg = dataclasses.replace(reduced[0], chunked_attn=True, attn_chunk=16)
    pcfg = dataclasses.replace(reduced_config("stablelm-1.6b"),
                               chunked_attn=True, attn_chunk=16)
    got, want = _logits_pair(jcfg, pcfg, reduced[1], _tokens(jcfg, 2, s))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_quickstart_ordering_holds_in_the_port(reduced):
    """examples/quickstart.py's assertion: QMC drifts less than RTN-INT4."""
    _, _, pparams = reduced
    cfg = reduced_config("stablelm-1.6b")
    toks = torch.from_numpy(_tokens(cfg, 2, 32)).long()
    ref = forward(cfg, pparams, toks)

    def drift(method):
        q = apply.quantize_model(pparams, method, qmc=QMCConfig(rho=0.3),
                                 min_dim=64)
        out = forward(cfg, q, toks)
        return float((out - ref).abs().mean() / (ref.abs().mean() + 1e-9))
    assert drift("qmc") < drift("rtn4")
