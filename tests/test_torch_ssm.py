"""The port's Mamba2 SSD mixer (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) on the CPU, on the same numpy inputs.

Tolerances, all fp32 on both sides (torch and XLA sum the einsums and
cumulative sums in their own orders, and ``exp(segsum)`` over a chunk
carries the cumulative sums' rounding):

  * ``ssd_chunked``: ``y`` and ``h_final`` within 2e-5 absolute plus 2e-5
    relative of the JAX scan, at chunks 8, 16 and 256, with and without
    an initial state; within 1e-3 of the token-by-token float64
    recurrence (as ``tests/test_moe_ssm.py`` holds JAX's); two halves
    with the state carried within 1e-5 of the whole sequence;
  * ``_causal_conv``: within 1e-6 of JAX; the gathered cache equal;
  * ``mamba_block`` (d 64, d_state 16, head dim 16, 1 or 2 groups): output
    within 1e-5 absolute plus 1e-5 relative, the ``ssm`` state within
    1e-5, the ``conv`` rows within 1e-6, at s = 1 (the recurrence) and
    s = 5, 16 and 40 (the chunked scan, padded and two chunks), with
    lanes at full, partial and zero valid length;
  * a lane with ``valid_len == 0`` leaves its ``ssm`` and ``conv`` rows
    bit for bit unchanged (``torch.equal``), through both paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models.blocks import init_mamba_params as jax_init_mamba
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from test_torch_bridge import jax_tree_to_numpy

MIXER = dict(name="m", family="ssm", n_layers=2, d_model=64, n_heads=0,
             n_kv_heads=0, head_dim=1, d_ff=0, vocab=128, pattern=("mamba",),
             d_state=16, ssm_headdim=16)


def _ssd_inputs(seed, l, h=4, p=8, g=2, n=16, bsz=2, with_h0=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bsz, l, h, p)) * 0.5).astype(np.float32)
    a_dt = (-np.abs(rng.standard_normal((bsz, l, h))) * 0.3
            ).astype(np.float32)
    b = (rng.standard_normal((bsz, l, g, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bsz, l, g, n)) * 0.3).astype(np.float32)
    h0 = ((rng.standard_normal((bsz, h, p, n)) * 0.5).astype(np.float32)
          if with_h0 else None)
    return x, a_dt, b, c, h0


def _both_ssd(args, chunk):
    x, a_dt, b, c, h0 = args
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, a_dt, b, c)),
                              None if h0 is None else jnp.asarray(h0),
                              chunk=chunk)
    ty, th = ssm.ssd_chunked(*(torch.from_numpy(v) for v in (x, a_dt, b, c)),
                             None if h0 is None else torch.from_numpy(h0),
                             chunk=chunk)
    return (np.asarray(jy), np.asarray(jh)), (ty.numpy(), th.numpy())


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
@pytest.mark.parametrize("chunk,l", [(8, 32), (16, 48), (256, 256)])
def test_ssd_chunked_matches_jax(chunk, l, with_h0):
    (jy, jh), (ty, th) = _both_ssd(
        _ssd_inputs(chunk + l, l, with_h0=with_h0), chunk)
    np.testing.assert_allclose(ty, jy, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(th, jh, atol=2e-5, rtol=2e-5)


def _ssd_naive(x, a_dt, b, c):
    """Token-by-token recurrence in float64 (``tests/test_moe_ssm.py``)."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    hg = h // b.shape[2]
    bh, ch = np.repeat(b, hg, axis=2), np.repeat(c, hg, axis=2)
    xn, an = x.astype(np.float64), a_dt.astype(np.float64)
    state = np.zeros((bsz, h, p, n))
    ys = np.zeros((bsz, l, h, p))
    for t in range(l):
        state = state * np.exp(an[:, t])[:, :, None, None] + \
            np.einsum("bhp,bhn->bhpn", xn[:, t], bh[:, t])
        ys[:, t] = np.einsum("bhpn,bhn->bhp", state, ch[:, t])
    return ys, state


@pytest.mark.parametrize("l,chunk", [(32, 8), (64, 16), (24, 8)])
def test_ssd_chunked_matches_naive(l, chunk):
    x, a_dt, b, c, _ = _ssd_inputs(l, l)
    y, hf = ssm.ssd_chunked(*(torch.from_numpy(v) for v in (x, a_dt, b, c)),
                            None, chunk=chunk)
    y_ref, h_ref = _ssd_naive(x, a_dt, b, c)
    np.testing.assert_allclose(y.numpy().astype(np.float64), y_ref,
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(hf.numpy().astype(np.float64), h_ref,
                               atol=1e-3, rtol=1e-3)


def test_ssd_initial_state_continuation():
    """Two halves with the state carried == the whole sequence."""
    x, a_dt, b, c, _ = _ssd_inputs(1, 32, h=2, p=4, g=1, n=8, bsz=1)
    t = [torch.from_numpy(v) for v in (x, a_dt, b, c)]
    y_full, h_full = ssm.ssd_chunked(*t, None, chunk=8)
    y1, h1 = ssm.ssd_chunked(*(v[:, :16] for v in t), None, chunk=8)
    y2, h2 = ssm.ssd_chunked(*(v[:, 16:] for v in t), h1, chunk=8)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(h2, h_full, atol=1e-5, rtol=1e-5)


def test_segsum_masks_to_minus_inf():
    a = torch.tensor([[0.5, -1.0, 2.0]])
    m = ssm._segsum(a)
    want = np.asarray(jssm._segsum(jnp.asarray(a.numpy())))
    np.testing.assert_array_equal(np.isneginf(m.numpy()), np.isneginf(want))
    np.testing.assert_allclose(m.numpy()[np.isfinite(want)],
                               want[np.isfinite(want)], atol=1e-7)
    assert torch.equal(torch.exp(m)[0].triu(1), torch.zeros(3, 3))


@pytest.mark.parametrize("valid", [None, 0, 2, 6],
                         ids=["no-cache", "valid0", "valid<K-1", "full"])
def test_causal_conv_matches_jax(valid):
    rng = np.random.default_rng(4)
    bsz, l, ch, k = 3, 6, 10, 4
    x = rng.standard_normal((bsz, l, ch)).astype(np.float32)
    w = rng.standard_normal((ch, k)).astype(np.float32)
    cache = (None if valid is None
             else rng.standard_normal((bsz, k - 1, ch)).astype(np.float32))
    vl = None if valid is None else np.full(bsz, valid, np.int32)
    jout, jc = jssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if cache is None else jnp.asarray(cache),
        None if vl is None else jnp.asarray(vl))
    tout, tc = ssm._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if cache is None else torch.from_numpy(cache),
        None if vl is None else torch.from_numpy(vl))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-6,
                               rtol=1e-6)
    if cache is None:
        assert tc is None and jc is None
        return
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if valid == 0:
        np.testing.assert_array_equal(tc.numpy(), cache)


def _mixer(ngroups, seed=0):
    jcfg = JaxModelConfig(**MIXER, ssm_ngroups=ngroups)
    cfg = ModelConfig(**MIXER, ssm_ngroups=ngroups)
    jp = jax_init_mamba(jax.random.PRNGKey(seed), jcfg)
    # norm_scale is 0 at init; give it values so the gated norm shows
    rng = np.random.default_rng(seed)
    jp["norm_scale"] = jnp.asarray(
        rng.standard_normal(cfg.d_inner).astype(np.float32) * 0.1)
    return jcfg, cfg, jp, params_from_numpy(jax_tree_to_numpy(jp),
                                            device="cpu")


def _cache(cfg, bsz, rng):
    return {"ssm": (rng.standard_normal((bsz, cfg.ssm_nheads,
                                         cfg.ssm_headdim, cfg.d_state))
                    * 0.3).astype(np.float32),
            "conv": rng.standard_normal((bsz, cfg.d_conv - 1, cfg.conv_dim)
                                        ).astype(np.float32)}


@pytest.mark.parametrize("ngroups", [1, 2])
@pytest.mark.parametrize("s", [1, 5, 16, 40])
def test_mamba_block_matches_jax_with_cache(s, ngroups):
    jcfg, cfg, jp, tp = _mixer(ngroups)
    rng = np.random.default_rng(s)
    valid = np.array([s, max(1, s // 2), 0], np.int32)
    x = rng.standard_normal((3, s, cfg.d_model)).astype(np.float32)
    cache = _cache(cfg, 3, rng)
    jout, jc = jax.jit(jssm.mamba_block, static_argnums=2)(
        jp, jnp.asarray(x), jcfg,
        cache={k: jnp.asarray(v) for k, v in cache.items()},
        valid_len=jnp.asarray(valid))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ssm_leaf, conv_leaf = tcache["ssm"], tcache["conv"]
    tout = ssm.mamba_block(tp, torch.from_numpy(x), cfg, cache=tcache,
                           valid_len=torch.from_numpy(valid))
    # the state was written into the cache's own tensors
    assert tcache["ssm"] is ssm_leaf and tcache["conv"] is conv_leaf
    live = valid > 0
    np.testing.assert_allclose(tout.numpy()[live], np.asarray(jout)[live],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ssm_leaf.numpy(), np.asarray(jc["ssm"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(conv_leaf.numpy(), np.asarray(jc["conv"]),
                               atol=1e-6, rtol=1e-6)
    # the idle lane (valid_len 0) kept both states bit for bit
    assert torch.equal(ssm_leaf[2], torch.from_numpy(cache["ssm"][2]))
    assert torch.equal(conv_leaf[2], torch.from_numpy(cache["conv"][2]))


def test_mamba_block_cacheless_matches_jax():
    jcfg, cfg, jp, tp = _mixer(1, seed=3)
    x = np.random.default_rng(9).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    jout, jc = jax.jit(jssm.mamba_block, static_argnums=2)(
        jp, jnp.asarray(x), jcfg)
    tout = ssm.mamba_block(tp, torch.from_numpy(x), cfg)
    assert jc is None
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("s", [1, 8])
def test_idle_lane_state_bit_exact(s):
    """Every lane idle (``valid_len`` 0): both states come back equal, bit
    for bit, through the recurrence (s = 1) and the chunked scan."""
    _, cfg, _, tp = _mixer(1, seed=5)
    rng = np.random.default_rng(11)
    cache = {k: torch.from_numpy(v)
             for k, v in _cache(cfg, 2, rng).items()}
    before = {k: v.clone() for k, v in cache.items()}
    x = torch.from_numpy(rng.standard_normal(
        (2, s, cfg.d_model)).astype(np.float32))
    ssm.mamba_block(tp, x, cfg, cache=cache,
                    valid_len=torch.zeros(2, dtype=torch.int32))
    for k in cache:
        assert torch.equal(cache[k], before[k]), k
