"""GPTQ and AWQ with the forward's calibration taps: the port
(``repro_torch.models.model.forward(..., taps=)``, ``core.gptq``,
``core.awq``, ``core.apply.quantize_model``) against the JAX package on
the same inputs, on the CPU.

Tolerances: taps allclose at rtol 1e-5 and an atol of 1e-5 * max|tap|:
two fp32 forwards that sum in different orders drift apart by a few tens
of ulps of the largest activation by the last layer (measured: up to
4.7e-6 * max|tap| on reduced hymba-1.5b's 8 layers), so an absolute 1e-6
holds only where nothing has been summed yet: group 0's first tap (an
embedding lookup and one rms_norm) is held at rtol 1e-5 / atol 1e-6, and
the port's tap mechanism (key, stride, concatenation) bit for bit against
its own forward; ``gptq_quantize`` / ``awq_quantize`` on
the same numpy ``(w, x)`` within 1e-6 * max|w| (both float64: only a
rounding flip on a tie could exceed it); ``quantize_model`` fed JAX's taps
the same, leaf for leaf; fed each side's own fp32 taps, >= 0.999 of the
elements within rtol 1e-5 (a tap's last bit can flip a rounding, which
GPTQ then carries along its output row)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.core import apply as jax_apply
from repro.core.awq import awq_quantize as jax_awq
from repro.core.gptq import gptq_quantize as jax_gptq
from repro.core.qconfig import AWQConfig as JaxAWQConfig
from repro.core.qconfig import GPTQConfig as JaxGPTQConfig
from repro.models.model import forward as jax_forward
from repro.models.model import init_params as jax_init
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import reduced_config
from repro_torch.core import apply
from repro_torch.core.awq import awq_quantize
from repro_torch.core.gptq import gptq_quantize
from repro_torch.core.qconfig import AWQConfig, GPTQConfig
from repro_torch.models.model import forward
from test_torch_bridge import jax_tree_to_numpy

TAP_RTOL, TAP_ATOL = 1e-5, 1e-6
TAP_SCALED_ATOL = 1e-5  # x max|tap|, past the first rms_norm
W_TOL = 1e-6            # x max|w|


def _np(x):
    return np.asarray(jax.device_get(x))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _model(arch):
    jcfg = jax_reduced(arch)
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    return jcfg, reduced_config(arch), jparams, pparams


def _tokens(cfg, b=2, s=48, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _taps(jcfg, pcfg, jparams, pparams, toks, calls=1):
    jt, pt = {}, {}
    for _ in range(calls):
        jax_forward(jcfg, jparams, jnp.asarray(toks), taps=jt,
                    scan_layers=False)
        forward(pcfg, pparams, torch.from_numpy(toks).long(), taps=pt)
    return jt, pt


@pytest.fixture(scope="module")
def stablelm():
    jcfg, pcfg, jparams, pparams = _model("stablelm-1.6b")
    # 2 x 320 rows a call: subsampled to 512 with a stride of 1, then two
    # calls concatenated
    toks = _tokens(jcfg, b=2, s=320)
    jt, pt = _taps(jcfg, pcfg, jparams, pparams, toks, calls=2)
    return jcfg, pcfg, jparams, pparams, jt, pt


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "hymba-1.5b"])
def test_taps_match_jax(arch, stablelm):
    if arch == "stablelm-1.6b":
        _, _, _, _, jt, pt = stablelm
    else:
        jcfg, pcfg, jparams, pparams = _model(arch)
        jt, pt = _taps(jcfg, pcfg, jparams, pparams, _tokens(jcfg))
    assert pt.keys() == jt.keys()
    names = {k.split("/", 2)[2] for k in pt}
    if arch == "hymba-1.5b":
        assert {"b0/mamba/in_proj", "b0/mamba/out_proj", "b0/attn/wq",
                "b0/attn/wo", "b0/ffn/w_up", "b0/ffn/w_down"} <= names
    else:
        assert names == {"b0/attn/wq", "b0/attn/wo", "b0/ffn/w_up",
                         "b0/ffn/w_down"}
        # two calls of 640 rows each, subsampled to 512 and concatenated
        assert all(v.shape[0] == 1024 for v in pt.values())
    for k in pt:
        assert pt[k].shape == jt[k].shape, k
        assert not pt[k].requires_grad
        want = _np(jt[k])
        atol = TAP_SCALED_ATOL * float(np.abs(want).max())
        np.testing.assert_allclose(pt[k].numpy(), want, rtol=TAP_RTOL,
                                   atol=atol, err_msg=k)
    first = "blocks/0/b0/attn/wq"
    np.testing.assert_allclose(pt[first].numpy(), _np(jt[first]),
                               rtol=TAP_RTOL, atol=TAP_ATOL)


def test_tap_rows_are_strided_and_concatenated(stablelm):
    """Group 0's first tap is the first block's rms_norm of the
    embeddings: each call's 640 rows at a stride of 640 // 512 = 1, cut
    to 512, and the second call's rows after the first's, bit for bit."""
    _, pcfg, _, pparams, _, pt = stablelm
    from repro_torch.models.layers import embed_tokens, rms_norm
    toks = torch.from_numpy(_tokens(pcfg, b=2, s=320)).long()
    x = embed_tokens(toks, pparams["embed"]["tok"], pcfg.scale_embed)
    h = rms_norm(x, pparams["blocks"]["b0"]["norm1"][0], pcfg.norm_eps)
    rows = h.reshape(-1, pcfg.d_model)[::1][:512]
    assert torch.equal(pt["blocks/0/b0/attn/wq"],
                       torch.cat([rows, rows]))
    taps = {}
    forward(pcfg, pparams, toks[:, :300].repeat(4, 1), taps=taps)
    # 1200 rows: a stride of 2, cut to 512
    assert taps["blocks/0/b0/attn/wq"].shape[0] == 512


def _wx(din, dout, n, seed, dead=()):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32)
    w[rng.random((din, dout)) < 0.01] *= 8.0          # a few outliers
    x = rng.standard_normal((n, din)).astype(np.float32)
    x *= np.exp(rng.standard_normal(din)).astype(np.float32)  # skewed
    x[:, list(dead)] = 0.0
    return w, x


@pytest.mark.parametrize("din,dout,n,dead", [
    (128, 64, 256, ()), (200, 96, 160, (3, 77)), (384, 128, 512, ())])
@pytest.mark.parametrize("bits", [4, 3])
def test_gptq_matches_jax(din, dout, n, dead, bits):
    """Column-wise rounding with block error propagation; din off the
    128-column block (200), dead input columns, 3 and 4 bits."""
    w, x = _wx(din, dout, n, seed=din + bits, dead=dead)
    want = np.asarray(jax_gptq(w, x, JaxGPTQConfig(bits=bits)))
    cfg = GPTQConfig(bits=bits)
    got = gptq_quantize(torch.from_numpy(w), torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and got.shape == w.shape
    tol = W_TOL * np.abs(w).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # numpy in, numpy out, the same numbers
    got_np = gptq_quantize(w, x, cfg)
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_array_equal(got_np, got.numpy())
    # the calibration changes the result against plain rounding
    rtn = apply.rtn_quantize(torch.from_numpy(w), bits).numpy()
    assert not np.array_equal(got.numpy(), rtn)


@pytest.mark.parametrize("din,dout,n", [(128, 64, 256), (200, 96, 160)])
@pytest.mark.parametrize("n_grid", [20, 7])
def test_awq_matches_jax(din, dout, n, n_grid):
    w, x = _wx(din, dout, n, seed=din + n_grid)
    want = np.asarray(jax_awq(w, x, JaxAWQConfig(n_grid=n_grid)))
    got = awq_quantize(torch.from_numpy(w), torch.from_numpy(x),
                       AWQConfig(n_grid=n_grid))
    tol = W_TOL * np.abs(w).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_array_equal(awq_quantize(w, x, AWQConfig(
        n_grid=n_grid)), got.numpy())


# the leaves the reduced stablelm's taps calibrate, per group (wk / wv
# through wq's tap, w_gate through w_up's)
CALIBRATED = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "ffn/w_up",
              "ffn/w_gate", "ffn/w_down")


@pytest.mark.parametrize("method", ["gptq", "awq"])
def test_quantize_model_on_jax_taps_matches_jax(stablelm, method):
    """Both packages calibrate on the same (JAX's) taps: every leaf within
    1e-6 * max|w|; the stacked ``blocks/b0/...`` leaves were calibrated
    per group, not rounded (the tap key ``blocks/{g}/b0/...`` mapping)."""
    _, _, jparams, pparams, jt, _ = stablelm
    jq = dict(_flat(jax_apply.quantize_model(jparams, method, taps=jt)))
    taps = {k: torch.tensor(_np(v)) for k, v in jt.items()}
    pq = dict(_flat(apply.quantize_model(pparams, method, taps=taps)))
    rtn = dict(_flat(apply.quantize_model(pparams, "rtn4")))
    p_in = dict(_flat(pparams))
    assert pq.keys() == jq.keys()
    for k in pq:
        tol = W_TOL * float(p_in[k].abs().max())
        np.testing.assert_allclose(pq[k].numpy(), _np(jq[k]), rtol=0,
                                   atol=tol, err_msg=k)
    for name in CALIBRATED:
        k = f"blocks/b0/{name}"
        for g in range(pq[k].shape[0]):
            assert not torch.equal(pq[k][g], rtn[k][g]), (k, g)
    # no tap for the head: RTN, as the reference falls back
    assert torch.equal(pq["lm_head"], rtn["lm_head"])
    assert apply.model_bits_per_weight(pparams, method) \
        == jax_apply.model_bits_per_weight(jparams, method) == pytest.approx(
            apply.model_bits_per_weight(pparams, "rtn4"))


@pytest.mark.parametrize("method", ["gptq", "awq"])
def test_quantize_model_on_own_taps_matches_jax(stablelm, method):
    """Each package calibrates on the taps its own forward captured."""
    _, _, jparams, pparams, jt, pt = stablelm
    jq = dict(_flat(jax_apply.quantize_model(jparams, method, taps=jt)))
    pq = dict(_flat(apply.quantize_model(pparams, method, taps=pt)))
    for k in pq:
        close = np.isclose(pq[k].numpy(), _np(jq[k]), rtol=1e-5, atol=0)
        assert close.mean() >= 0.999, (k, close.mean())


def test_quantize_model_calibrates_on_the_leafs_device_and_dtype(stablelm):
    """A bf16 leaf comes back bf16; an unstacked leaf with a tap of its
    own calibrates on it; a group without a tap falls back to RTN."""
    _, _, _, pparams, _, pt = stablelm
    w = pparams["blocks"]["b0"]["ffn"]["w_down"]
    tree = {"proj": w[0].to(torch.bfloat16),
            "blocks": {"b0": {"ffn": {"w_down": w}}}}
    taps = {"proj": pt["blocks/0/b0/ffn/w_down"],
            "blocks/1/b0/ffn/w_down": pt["blocks/1/b0/ffn/w_down"]}
    q = apply.quantize_model(tree, "gptq", taps=taps)
    assert q["proj"].dtype == torch.bfloat16
    want = gptq_quantize(w[0].to(torch.bfloat16), taps["proj"])
    assert torch.equal(q["proj"], want)
    stacked = q["blocks"]["b0"]["ffn"]["w_down"]
    assert torch.equal(stacked[0], apply.rtn_quantize(w[0], 4))
    assert torch.equal(stacked[1], gptq_quantize(w[1], taps[
        "blocks/1/b0/ffn/w_down"]))
