"""The port's bit packing (``repro_torch.core.packing``) and its 3-bit read
path (``kernels.ops.unpack3b`` and its plain version) against the JAX
package's on the CPU: the same codes give the same bytes, and the same
bytes decode to the same codes, exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jax_packing
from repro.kernels import ops as jax_ops
from repro.kernels.ref import unpack3b_ref as jax_unpack3b_ref
from repro.kernels.unpack3b import unpack3b_pallas
from repro_torch.core import packing
from repro_torch.kernels import ops
from repro_torch.kernels.ref import unpack3b_ref
from repro_torch.kernels.unpack3b import unpack3b_call


def _codes(n, bits, seed=0):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return np.random.default_rng(seed + n).integers(lo, hi + 1, size=n)


@pytest.mark.parametrize("n", [8, 13, 1024, 8192])
@pytest.mark.parametrize("bits", [3, 5])
def test_pack_codes_bytes_match_jax_and_round_trip(bits, n):
    codes = _codes(n, bits)
    want = np.asarray(jax_packing.pack_codes(codes, bits))
    got = packing.pack_codes(torch.from_numpy(codes), bits)
    assert got.dtype == torch.uint8
    assert got.numel() == packing.packed_nbytes(n, bits) == want.size
    np.testing.assert_array_equal(got.numpy(), want)
    back = packing.unpack_codes(got, bits, n)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_packing.unpack_codes(want, bits, n)))


def test_pack_codes_packs_any_shape_and_refuses_out_of_range():
    codes = torch.from_numpy(_codes(96, 3, seed=1))
    packed = packing.pack_codes(codes.reshape(-1, 8), 3)
    np.testing.assert_array_equal(unpack3b_ref(packed, 96).numpy(),
                                  codes.numpy())
    with pytest.raises(ValueError):
        packing.pack_codes(torch.tensor([4]), 3)
    assert packing.cells_per_weight(3, 2) == \
        jax_packing.cells_per_weight(3, 2) == 1.5


@pytest.mark.parametrize("n", [1024, 2048, 8192])
def test_unpack3b_matches_the_pallas_kernel_and_oracle(n):
    codes = _codes(n, 3, seed=2)
    packed = np.array(jax_packing.pack_codes(codes, 3))
    want = np.asarray(unpack3b_pallas(jnp.asarray(packed), n,
                                      interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jax_unpack3b_ref(jnp.asarray(packed), n)))
    tp = torch.from_numpy(packed)
    for got in (unpack3b_ref(tp, n), ops.unpack3b(tp, n),
                unpack3b_call(tp, n)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, codes)


def test_unpack3b_dispatch_takes_the_plain_version_off_the_kernel_grid():
    """n % 8 != 0 has no whole 3-byte groups; the reference's dispatcher
    takes its plain version there. The port's takes its plain version on
    every CPU tensor (on the card its kernel decodes a partial last quad)."""
    n = 13
    codes = _codes(n, 3, seed=3)
    packed = np.array(jax_packing.pack_codes(codes, 3))
    got = ops.unpack3b(torch.from_numpy(packed), n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ops.unpack3b(jnp.asarray(packed), n)))
    np.testing.assert_array_equal(got.numpy(), codes)
