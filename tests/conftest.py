import os
import sys

# tests see ONE cpu device (the dry-run subprocess sets its own flags)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.models.config import ModelConfig  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running (subprocess compile-heavy) tests")
    config.addinivalue_line(
        "markers", "kernel: Pallas kernel parity sweeps (the `-m kernel` "
        "CI lane runs these in both matrix jobs)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the PyTorch port's hand-written "
        "kernels); skips without one")


# ---------------------------------------------------------------------------
# shared serving fixtures: one tiny dense config (fp32 + int8-KV variants)
# with session-cached params, reused by test_prefix_cache.py and
# test_paged_attention_kernel.py so the kernel-vs-reference engine parity
# tests extend the existing fixtures instead of duplicating them.
# ---------------------------------------------------------------------------
SERVE_BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab=64)


@pytest.fixture(scope="session")
def serve_cfg():
    return ModelConfig(name="t", family="dense", **SERVE_BASE)


@pytest.fixture(scope="session")
def serve_cfg_int8():
    return ModelConfig(name="t8", family="dense", kv_cache_quant=True,
                       **SERVE_BASE)


@pytest.fixture(scope="session")
def serve_params(serve_cfg):
    from repro.models.model import init_params
    return init_params(serve_cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="session")
def serve_params_int8(serve_cfg_int8):
    from repro.models.model import init_params
    return init_params(serve_cfg_int8, jax.random.PRNGKey(0))


@pytest.fixture(scope="session")
def tiny_dense():
    return ModelConfig(name="t-dense", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab=128)


@pytest.fixture(scope="session")
def tiny_moe():
    return ModelConfig(name="t-moe", family="moe", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                       n_experts=4, topk=2, moe_pattern=(True,))


@pytest.fixture(scope="session")
def tiny_mamba():
    return ModelConfig(name="t-mamba", family="ssm", n_layers=2, d_model=64,
                       n_heads=0, n_kv_heads=0, head_dim=1, d_ff=0,
                       vocab=128, pattern=("mamba",), d_state=16,
                       ssm_headdim=16)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# paged-attention differential-harness helpers (test_paged_attention_kernel)
# ---------------------------------------------------------------------------
def make_paged_case(rng, *, page=8, n_kv=2, gqa=2, hd=16, quantized=False,
                    seq_lens=(0, 1, 7, 8, 9, 16, 24), n_tbl=None,
                    poison=1e3):
    """Build one (q, cache, seq_len) paged-decode case.

    Lanes with seq 0 keep an all-null block table (parked on page 0);
    live lanes get *shuffled* page ids so the gather is genuinely
    indirect. The null page is poisoned with ``poison`` so any leak of
    dead-page data breaks parity loudly."""
    import jax.numpy as jnp
    seq = np.asarray(seq_lens, np.int32)
    bsz, kvd = len(seq), n_kv * hd
    live = [max(0, -(-int(L) // page)) for L in seq]
    n_tbl = n_tbl or max(max(live), 1) + 1          # slack dead tail slots
    n_pages = 1 + sum(live) + 2                     # null + live + spare
    kf = rng.standard_normal((n_pages, page, n_kv, hd)).astype(np.float32)
    vf = rng.standard_normal((n_pages, page, n_kv, hd)).astype(np.float32)
    kf[0] = vf[0] = poison
    ids = list(rng.permutation(np.arange(1, n_pages)))
    tbl = np.zeros((bsz, n_tbl), np.int32)
    for b in range(bsz):
        for j in range(live[b]):
            tbl[b, j] = ids.pop()
    cache = {"block_tbl": jnp.asarray(tbl)}
    if quantized:
        from repro.models.kvcache import quantize_kv
        kq, ks = quantize_kv(jnp.asarray(kf))
        vq, vs = quantize_kv(jnp.asarray(vf))
        cache.update(k_pages=kq.reshape(n_pages, page, kvd),
                     v_pages=vq.reshape(n_pages, page, kvd),
                     k_scale_pages=ks, v_scale_pages=vs)
    else:
        cache.update(k_pages=jnp.asarray(kf.reshape(n_pages, page, kvd)),
                     v_pages=jnp.asarray(vf.reshape(n_pages, page, kvd)))
    q = jnp.asarray(rng.standard_normal(
        (bsz, 1, n_kv * gqa, hd)).astype(np.float32))
    return q, cache, jnp.asarray(seq)


def paged_reference(q, cache, seq, *, n_kv, hd, window=None,
                    attn_softcap=None):
    """Reference decode attention: full-width gather + masked attend."""
    import jax.numpy as jnp
    from repro.models.attention import attend, paged_cache_read
    k_all, v_all = paged_cache_read(cache, jnp.float32, n_kv, hd)
    bsz, t = k_all.shape[:2]
    kv_pos = jnp.broadcast_to(jnp.arange(t)[None], (bsz, t))
    return attend(q, k_all, v_all,
                  q_positions=jnp.maximum(seq - 1, 0)[:, None],
                  kv_positions=kv_pos, kv_valid_len=seq, causal=True,
                  window=window, attn_softcap=attn_softcap)


def make_ragged_case(rng, *, page=8, n_kv=2, gqa=2, hd=16, quantized=False,
                     lanes=((0, 0), (0, 1), (3, 5), (8, 8)), n_tbl=None,
                     poison=1e3):
    """Build one multi-query (ragged) paged case.

    ``lanes`` is a per-lane ``(q_start, n_new)`` list: the lane's chunk of
    ``n_new`` query tokens sits at absolute positions ``q_start + t`` and
    its valid KV length is ``q_start + n_new`` (the chunk's own K/V are
    already scattered, exactly the state ``attn_block`` hands the kernel).
    Live lanes get shuffled page ids so the gather is genuinely indirect;
    the null page is poisoned so any dead-page leak breaks parity loudly.
    Returns (q [B, S, H, hd], cache, q_start [B], n_new [B]) with
    S = max(n_new, 1)."""
    import jax.numpy as jnp
    q_start = np.asarray([l[0] for l in lanes], np.int32)
    n_new = np.asarray([l[1] for l in lanes], np.int32)
    kv_len = q_start + n_new
    bsz, kvd = len(lanes), n_kv * hd
    s = max(1, int(n_new.max()))
    live = [-(-int(L) // page) if L else 0 for L in kv_len]
    n_tbl = n_tbl or max(max(live), 1) + 1          # slack dead tail slots
    n_pages = 1 + sum(live) + 2                     # null + live + spare
    kf = rng.standard_normal((n_pages, page, n_kv, hd)).astype(np.float32)
    vf = rng.standard_normal((n_pages, page, n_kv, hd)).astype(np.float32)
    kf[0] = vf[0] = poison
    ids = list(rng.permutation(np.arange(1, n_pages)))
    tbl = np.zeros((bsz, n_tbl), np.int32)
    for b in range(bsz):
        for j in range(live[b]):
            tbl[b, j] = ids.pop()
    cache = {"block_tbl": jnp.asarray(tbl)}
    if quantized:
        from repro.models.kvcache import quantize_kv
        kq, ks = quantize_kv(jnp.asarray(kf))
        vq, vs = quantize_kv(jnp.asarray(vf))
        cache.update(k_pages=kq.reshape(n_pages, page, kvd),
                     v_pages=vq.reshape(n_pages, page, kvd),
                     k_scale_pages=ks, v_scale_pages=vs)
    else:
        cache.update(k_pages=jnp.asarray(kf.reshape(n_pages, page, kvd)),
                     v_pages=jnp.asarray(vf.reshape(n_pages, page, kvd)))
    q = jnp.asarray(rng.standard_normal(
        (bsz, s, n_kv * gqa, hd)).astype(np.float32))
    return q, cache, jnp.asarray(q_start), jnp.asarray(n_new)


def ragged_reference(q, cache, q_start, n_new, *, n_kv, hd, window=None,
                     attn_softcap=None):
    """Reference for the ragged kernel: full-width gather + masked attend
    at absolute query positions. Rows past a lane's ``n_new`` compute
    garbage here (the kernel zeroes them) — compare valid rows only."""
    import jax.numpy as jnp
    from repro.models.attention import attend, paged_cache_read
    k_all, v_all = paged_cache_read(cache, jnp.float32, n_kv, hd)
    bsz, t = k_all.shape[:2]
    s = q.shape[1]
    kv_pos = jnp.broadcast_to(jnp.arange(t)[None], (bsz, t))
    q_pos = q_start[:, None] + jnp.arange(s, dtype=jnp.int32)[None, :]
    return attend(q, k_all, v_all, q_positions=q_pos, kv_positions=kv_pos,
                  kv_valid_len=q_start + n_new, causal=True,
                  window=window, attn_softcap=attn_softcap)
