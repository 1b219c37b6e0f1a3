"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA card and skips
without one; this file imports no JAX, so on a machine with a card and no
JAX it runs alone:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_gpu.py

Tolerances: qmm fp32 max abs error <= 1e-4 * max|y| (the same fp32
products summed in another order), bf16 <= 1e-2 * max|y| (one bf16 ulp is
2^-8 of the value); attention fp32 atol 1e-5 / rtol 1e-4, rows at or past
kv_len exactly 0; unpack3b bit-exact."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.packing import pack_codes  # noqa: E402
from repro_torch.core.qconfig import QMCConfig  # noqa: E402
from repro_torch.core.qtensor import quantize_qtensor  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import qmm as kqmm  # noqa: E402
from repro_torch.kernels import unpack3b as kunpack  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    ragged_paged_attention_call)
from repro_torch.kernels.ref import (qmm_ref,  # noqa: E402
                                     ragged_paged_attention_ref,
                                     unpack3b_ref)
from repro_torch.models.kvcache import quantize_kv  # noqa: E402

pytestmark = pytest.mark.gpu

QMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _from_chip_smoke(name):
    """A case builder of chip_smoke.py (the same inputs on both)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return getattr(chip_smoke, name)


def _streams(k, n, gen):
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    big = torch.rand((k, n), generator=gen, device="cuda") < 0.002
    return quantize_qtensor(torch.where(big, 8 * w, w),
                            QMCConfig(rho=0.3, granularity="subtile"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [1, 4, 7, 8, 128, 384])
@pytest.mark.parametrize("k,n", [(256, 384), (2048, 2048), (5632, 2048)])
def test_qmm_kernels_match_plain(gen, m, k, n, dtype):
    qt = _streams(k, n, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    build.reset_launches()
    kops.reset_path_counts()
    y = kops.qmm(x, qt)
    want = qmm_ref(x, qt)
    torch.cuda.synchronize()
    path = "colstrip" if m >= 128 else "decode"
    assert kops.path_counts[path] == 1 and kops.path_counts["ref"] == 0
    assert build.launches[f"qmm_{path}"] == 1
    assert y.dtype == dtype and y.shape == (m, n)
    err = (y.float() - want.float()).abs().max().item()
    assert err <= QMM_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("pattern", ["all-inlier", "all-outlier",
                                     "checkerboard"])
@pytest.mark.parametrize("m,k,n", [(128, 2048, 2048), (256, 5632, 2048),
                                   (512, 2048, 5632), (128, 2048, 100352)],
                         ids=["split-K", "split-K-5632", "split-K-512",
                              "no-split"])
def test_colstrip_stream_patterns(gen, m, k, n, pattern, dtype):
    qt = _from_chip_smoke("patterned_qtensor")(k, n, pattern, gen)
    splits, _ = kqmm.colstrip_splits(m, k, n)
    assert (splits > 1) == (n < 100352)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    build.reset_launches()
    y = kqmm.qmm_colstrip(x, qt)
    again = kqmm.qmm_colstrip(x, qt)
    want = qmm_ref(x, qt)
    torch.cuda.synchronize()
    assert build.launches["qmm_colstrip"] == 2
    assert torch.equal(y, again)                      # deterministic
    err = (y.float() - want.float()).abs().max().item()
    assert err <= QMM_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_colstrip_lm_head_width(gen, dtype):
    """N = 100352, the full-width lm_head (K split off at M = 512)."""
    qt = _streams(2048, 100352, gen)
    x = torch.randn((512, 2048), generator=gen, device="cuda").to(dtype)
    y = kqmm.qmm_colstrip(x, qt)
    want = qmm_ref(x, qt)
    torch.cuda.synchronize()
    err = (y.float() - want.float()).abs().max().item()
    assert err <= QMM_TOL[dtype] * want.float().abs().max().item()


def test_qmm_kernels_never_take_the_plain_version(gen, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain qmm ran on a CUDA tensor")
    monkeypatch.setattr(kqmm, "qmm_ref", refuse)
    qt = _streams(256, 384, gen)
    for m, kernel in ((8, kqmm.qmm_decode), (128, kqmm.qmm_colstrip)):
        kernel(torch.randn((m, 256), device="cuda"), qt)
    torch.cuda.synchronize()


def test_qmm_wrappers_refuse_what_the_kernels_do_not_take(gen):
    qt = _streams(256, 384, gen)
    x = torch.randn((8, 256), device="cuda")
    with pytest.raises(TypeError):
        kqmm.qmm_decode(x.half(), qt)
    with pytest.raises(ValueError):
        kqmm.qmm_decode(x[:7], qt)                    # M % 8
    with pytest.raises(ValueError):
        kqmm.qmm_colstrip(x, qt)                      # M % 128
    with pytest.raises(ValueError):
        kqmm.qmm_decode(torch.randn((256, 8), device="cuda").T, qt)


def _attn_case(lanes, *, n_kv, g, hd, page, quantized, gen):
    return _from_chip_smoke("make_attn_case")(
        lanes, n_kv=n_kv, g=g, hd=hd, page=page, quantized=quantized,
        gen=gen)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("lanes,n_kv,g,window,cap", [
    (((0, 0), (0, 1), (3, 5), (8, 8), (13, 24), (40, 1)), 2, 2, None, None),
    (((69, 1), (192, 1), (0, 0), (5, 1)), 4, 1, None, None),
    (((0, 40), (16, 3), (0, 0), (33, 16)), 4, 2, 6, 2.0),
], ids=["ragged-gqa2", "decode", "window-softcap"])
def test_attention_kernel_matches_plain(gen, lanes, n_kv, g, window, cap,
                                        quantized):
    q, cache, qs, kl, n_new, _ = _attn_case(
        lanes, n_kv=n_kv, g=g, hd=64, page=16, quantized=quantized, gen=gen)
    kw = dict(n_kv=n_kv, head_dim=64, window=window, attn_softcap=cap)
    build.reset_launches()
    o, m, l = ragged_paged_attention_call(q, cache, qs, kl, **kw)
    o_r, m_r, l_r = ragged_paged_attention_ref(q, cache, qs, kl, **kw)
    torch.cuda.synchronize()
    assert build.launches["ragged_paged_attention"] == 1
    valid = torch.arange(q.shape[1], device="cuda")[None, :] < n_new[:, None]
    assert (o[~valid] == 0).all()
    for got, want in ((o, o_r), (m, m_r), (l, l_r)):
        torch.testing.assert_close(got[valid], want[valid], atol=1e-5,
                                   rtol=1e-4)


def _attn_check(lanes, *, n_kv, g, quantized, gen, window=None, cap=None,
                page=16, hd=64):
    """Kernel vs plain on one ragged case; returns the kernel's o. Rows at
    or past kv_len must be exactly 0 (m = -1e30, l = 0), two calls
    bit-identical."""
    q, cache, qs, kl, n_new, _ = _attn_case(
        lanes, n_kv=n_kv, g=g, hd=hd, page=page, quantized=quantized,
        gen=gen)
    kw = dict(n_kv=n_kv, head_dim=hd, window=window, attn_softcap=cap)
    build.reset_launches()
    o, m, l = ragged_paged_attention_call(q, cache, qs, kl, **kw)
    o2, m2, l2 = ragged_paged_attention_call(q, cache, qs, kl, **kw)
    o_r, m_r, l_r = ragged_paged_attention_ref(q, cache, qs, kl, **kw)
    torch.cuda.synchronize()
    assert build.launches["ragged_paged_attention"] == 2
    assert torch.equal(o, o2) and torch.equal(m, m2) and torch.equal(l, l2)
    valid = torch.arange(q.shape[1], device="cuda")[None, :] < n_new[:, None]
    assert (o[~valid] == 0).all() and (l[~valid] == 0).all()
    assert (m[~valid] == -1e30).all()
    for got, want in ((o, o_r), (m, m_r), (l, l_r)):
        torch.testing.assert_close(got[valid], want[valid], atol=1e-5,
                                   rtol=1e-4)
    return o


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("path", ["decode", "chunk"])
@pytest.mark.parametrize("kv", [1, 15, 16, 17, 4096])
def test_attention_kv_len_edges(gen, kv, path, quantized):
    """kv_len = 1, page - 1, page, page + 1 and 4096 (StableLM-2-1.6B's
    context; split over several spans) on the decode path (S = 1) and the
    chunk path (the last min(16, kv) positions as one q block, beside a
    16-token lane so that S = 16 even at kv_len 1)."""
    if path == "decode":
        lanes = ((kv - 1, 1), (0, 0), (kv // 2, 1))
    else:
        n = min(16, kv)
        lanes = ((kv - n, n), (0, 0), (40, 16))
    _attn_check(lanes, n_kv=4, g=1, quantized=quantized, gen=gen)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_attention_chunk_straddles_spans_with_window_and_gqa4(gen,
                                                              quantized):
    """One lane, one KV head, G = 4: the single work item is split into
    spans of one ring stage (64 keys), so the q block at positions 200-215
    (14 live pages) straddles four spans, and its window of 70 keys crosses
    the span boundary at key 128; softcap on."""
    from repro_torch.kernels.paged_attention import span_pages
    assert span_pages(1, 15, 16) == 4                 # 4 pages = 64 keys
    _attn_check(((200, 16),), n_kv=1, g=4, quantized=quantized, gen=gen,
                window=70, cap=30.0)
    _attn_check(((200, 16),), n_kv=1, g=4, quantized=quantized, gen=gen)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_attention_long_context_decode_mixed_lengths(gen, quantized):
    """Decode lanes at kv_len up to 4096 beside short and idle lanes: the
    long lanes take several spans merged in order, the short ones one."""
    lanes = ((4095, 1), (2047, 1), (5, 1), (0, 0), (3000, 1))
    _attn_check(lanes, n_kv=8, g=2, quantized=quantized, gen=gen)


def test_attention_wrapper_refuses_bf16_queries(gen):
    q, cache, qs, kl, _, _ = _attn_case(((0, 4),), n_kv=2, g=1, hd=64,
                                        page=16, quantized=False, gen=gen)
    with pytest.raises(TypeError):
        ragged_paged_attention_call(q.bfloat16(), cache, qs, kl, n_kv=2,
                                    head_dim=64)


def test_int8_pages_dequantize_like_the_plain_read(gen):
    """The kernel and the plain version read the same int8 arena written
    by quantize_kv (codes from the fp32 scale, scale stored as bf16)."""
    x = torch.randn((3, 16, 2, 64), generator=gen, device="cuda")
    codes, scale = quantize_kv(x)
    assert codes.dtype == torch.int8 and scale.dtype == torch.bfloat16
    back = codes.float() * scale.float()[..., None]
    assert (back - x).abs().max() <= 2 * x.abs().max() / 127


# the benchmarks/kernels.py size, the inlier streams of one 2048 x 5632
# projection and of the full-width lm_head at rho 0.3, a multiple of 8 that
# is not one of 32, and sizes that are not multiples of 8 (a partial last
# quad of 1, 2 or 3 codes, whose second byte may lie past the stream)
@pytest.mark.parametrize("n", [65_536, 8_074_240, 143_864_832, 65_544,
                               65_541, 1, 2, 3, 5, 12, 13, 14, 1027])
def test_unpack3b_kernel_matches_plain(gen, n):
    codes = torch.randint(-4, 4, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    packed = pack_codes(codes, 3)
    build.reset_launches()
    got = kops.unpack3b(packed, n)
    want = unpack3b_ref(packed, n)
    torch.cuda.synchronize()
    assert build.launches["unpack3b"] == 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(got, want) and torch.equal(got, codes)


def test_unpack3b_never_takes_the_plain_version_and_refuses_bad_streams(
        gen, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain unpack3b ran on a CUDA tensor")
    monkeypatch.setattr(kunpack, "unpack3b_ref", refuse)
    codes = torch.randint(-4, 4, (13,), generator=gen, device="cuda")
    packed = pack_codes(codes, 3)                 # 5 bytes, n % 8 != 0
    build.reset_launches()
    assert torch.equal(kops.unpack3b(packed, 13), codes.int())
    assert build.launches["unpack3b"] == 1
    with pytest.raises(TypeError):
        kunpack.unpack3b_call(packed.int(), 13)
    with pytest.raises(ValueError):
        kunpack.unpack3b_call(packed, 8)          # 5 bytes are not 3
    with pytest.raises(ValueError):
        kunpack.unpack3b_call(packed[:0], 0)
