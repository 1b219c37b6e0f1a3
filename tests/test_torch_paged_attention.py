"""The port's ragged paged attention (its plain version — what the
wrapper runs on a CPU tensor) against the JAX Pallas kernel in interpret
mode, on ``conftest.make_ragged_case`` inputs (the null page poisoned
with 1e3, shuffled page ids).

Tolerance: valid rows to atol/rtol 1e-5 (fp32 both sides: the port's
one-pass softmax against the kernel's page-by-page online softmax); rows
at or past a lane's kv_len exactly 0 on both sides."""
import numpy as np
import pytest
import torch

from conftest import make_paged_case, make_ragged_case
from repro.kernels.paged_attention import (paged_decode_attention,
                                           ragged_paged_attention as jax_rpa)
from repro_torch.bridge import arena_from_numpy
from repro_torch.kernels.paged_attention import (
    ragged_paged_attention, ragged_paged_attention_call)
from test_torch_bridge import jax_tree_to_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
MIXED = ((0, 0), (0, 1), (3, 5), (8, 8), (13, 24), (40, 1))


def _port_inputs(q, cache, *vecs):
    pc = arena_from_numpy(jax_tree_to_numpy(cache), device="cpu")
    return (torch.tensor(np.asarray(q)), pc,
            *(torch.tensor(np.asarray(v)) for v in vecs))


def _compare(q, cache, q_start, n_new, *, n_kv, hd, window=None,
             attn_softcap=None):
    want = np.asarray(jax_rpa(q, cache, q_start, q_start + n_new, n_kv=n_kv,
                              head_dim=hd, window=window,
                              attn_softcap=attn_softcap, interpret=True))
    tq, tc, tqs, tnn = _port_inputs(q, cache, q_start, n_new)
    got = ragged_paged_attention(tq, tc, tqs, tqs + tnn, n_kv=n_kv,
                                 head_dim=hd, window=window,
                                 attn_softcap=attn_softcap).numpy()
    s = q.shape[1]
    valid = np.arange(s)[None, :] < np.asarray(n_new)[:, None]
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    assert (got[~valid] == 0).all() and (want[~valid] == 0).all()
    return got


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("gqa", [1, 2], ids=["mha", "gqa2"])
def test_ragged_chunks_match_jax_kernel(quantized, gqa):
    rng = np.random.default_rng(0)
    q, cache, q_start, n_new = make_ragged_case(
        rng, quantized=quantized, gqa=gqa, lanes=MIXED)
    _compare(q, cache, q_start, n_new, n_kv=2, hd=16)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_decode_matches_jax_kernel(quantized):
    rng = np.random.default_rng(1)
    q, cache, seq = make_paged_case(rng, quantized=quantized)
    want = np.asarray(paged_decode_attention(q, cache, seq, n_kv=2,
                                             head_dim=16, interpret=True))
    tq, tc, tseq = _port_inputs(q, cache, seq)
    got = ragged_paged_attention(tq, tc, torch.clamp_min(tseq - 1, 0), tseq,
                                 n_kv=2, head_dim=16).numpy()
    live = np.asarray(seq) > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("window,softcap", [(4, None), (None, 5.0),
                                            (6, 2.0)],
                         ids=["window", "softcap", "both"])
def test_window_and_softcap_match_jax_kernel(window, softcap):
    rng = np.random.default_rng(2)
    q, cache, q_start, n_new = make_ragged_case(rng, gqa=2, lanes=MIXED)
    _compare(q, cache, q_start, n_new, n_kv=2, hd=16, window=window,
             attn_softcap=softcap)


def test_page_size_and_head_dim_variants():
    rng = np.random.default_rng(3)
    q, cache, q_start, n_new = make_ragged_case(
        rng, page=16, hd=32, n_kv=4, gqa=1, lanes=((0, 20), (16, 3),
                                                   (0, 0), (33, 16)))
    _compare(q, cache, q_start, n_new, n_kv=4, hd=32)


def test_softmax_state_of_dead_and_live_rows():
    """(m, l) from the plain version: dead rows keep the -1e30 / 0 init,
    and a one-key row has l == 1."""
    rng = np.random.default_rng(4)
    q, cache, q_start, n_new = make_ragged_case(
        rng, lanes=((0, 0), (0, 1), (3, 5)))
    tq, tc, tqs, tnn = _port_inputs(q, cache, q_start, n_new)
    o, m, l = ragged_paged_attention_call(tq, tc, tqs, tqs + tnn, n_kv=2,
                                          head_dim=16)
    assert (m[0] == -1e30).all() and (l[0] == 0).all()
    np.testing.assert_allclose(l[1, 0].numpy(), 1.0, rtol=1e-6)
    assert o.shape == tq.shape and m.shape == tq.shape[:3]
