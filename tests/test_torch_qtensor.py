"""The port's QMC PTQ (``repro_torch.core.qtensor``) against the JAX
package's on the same numpy matrices.

Tolerances: the subtile tags and stream positions must match exactly
(they are a sort and a cumulative sum of the same maxima); scales to rtol
1e-5; codes on >= 99.9% of entries. The two libraries sum the per-channel
losses in different orders and may round an alpha grid point differently
in its last bit, so a near-tie between two grid points may flip a
channel's choice."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jax_part
from repro.core.qconfig import QMCConfig as JaxQMCConfig
from repro.core.qtensor import dequantize_qtensor as jax_dequantize
from repro.core.qtensor import quantize_qtensor as jax_quantize
from repro_torch.bridge import params_from_numpy
from repro_torch.core import partition as part
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import dequantize_qtensor, quantize_qtensor
from repro_torch.core.quantizers import quantize_codes, scale_grid
from test_torch_bridge import jax_tree_to_numpy

CFG = dict(rho=0.3, granularity="subtile")


def _heavy(shape, seed):
    return np.random.default_rng(seed).standard_t(3.0, size=shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,seed", [((64, 256), 0), ((128, 384), 1),
                                        ((256, 128), 2)])
def test_quantize_qtensor_matches_jax(shape, seed):
    w = _heavy(shape, seed)
    jq = jax_quantize(jnp.asarray(w), JaxQMCConfig(**CFG))
    pq = quantize_qtensor(torch.from_numpy(w), QMCConfig(**CFG))
    np.testing.assert_array_equal(pq.is_out.numpy(), np.asarray(jq.is_out))
    np.testing.assert_array_equal(pq.stream_pos.numpy(),
                                  np.asarray(jq.stream_pos))
    np.testing.assert_allclose(pq.scale_in.numpy(), np.asarray(jq.scale_in),
                               rtol=1e-5)
    np.testing.assert_allclose(pq.scale_out.numpy(),
                               np.asarray(jq.scale_out), rtol=1e-5)
    for name in ("in_codes", "out_codes"):
        want = np.asarray(getattr(jq, name).astype(jnp.int8))
        got = getattr(pq, name).numpy()
        assert got.shape == want.shape
        assert (got == want).mean() >= 0.999, name
    assert pq.in_codes.dtype == torch.int8 and pq.shape == shape


def test_subtile_mask_tie_break_matches_jax():
    """Equal subtile maxima at the threshold: both keep the first k
    positions in row-major order."""
    w = np.ones((32, 512), np.float32)
    w[8:16, 128:256] = 3.0                     # one clear outlier subtile
    for rho in (0.1, 0.3, 0.5):
        want = np.asarray(jax_part.subtile_outlier_mask(jnp.asarray(w), rho))
        got = part.subtile_outlier_mask(torch.from_numpy(w), rho).numpy()
        np.testing.assert_array_equal(got, want)


def test_quantize_codes_round_half_to_even():
    w = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, 9.0, -9.0]])
    codes = quantize_codes(w, torch.ones(1, 7), 3)
    assert codes.tolist() == [[0.0, 2.0, 2.0, -0.0, -2.0, 3.0, -4.0]]


def test_scale_grid_within_an_ulp_of_jax():
    want = np.asarray(jnp.linspace(0.3, 1.05, 48))
    got = scale_grid(0.3, 1.05, 48).numpy()
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    assert got[0] == want[0] and got[-1] == want[-1]


def test_dequantize_carried_streams_exactly():
    """The JAX quantizer's own streams, carried over: the port
    reassembles the identical dense matrix."""
    w = _heavy((128, 512), 7)
    jq = jax_quantize(jnp.asarray(w), JaxQMCConfig(**CFG))
    pq = params_from_numpy({"w": jax_tree_to_numpy(jq)}, device="cpu")["w"]
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = dequantize_qtensor(pq, dt).to(torch.float32).numpy()
        want = np.asarray(jax_dequantize(jq, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
