"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA card and skips
without one; this file imports no JAX, so on a machine with a card and no
JAX it runs alone:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_gpu.py

Tolerances: qmm fp32 max abs error <= 1e-4 * max|y| (the same fp32
products summed in another order), bf16 <= 1e-2 * max|y| (one bf16 ulp is
2^-8 of the value); attention fp32 atol 1e-5 / rtol 1e-4, rows at or past
kv_len exactly 0."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.qconfig import QMCConfig  # noqa: E402
from repro_torch.core.qtensor import quantize_qtensor  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import qmm as kqmm  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    ragged_paged_attention_call)
from repro_torch.kernels.ref import (qmm_ref,  # noqa: E402
                                     ragged_paged_attention_ref)
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
    sys.path.insert(0, str(ROOT))
    try:
        from chip_smoke import make_attn_case
    finally:
        sys.path.remove(str(ROOT))
    return make_attn_case(lanes, n_kv=n_kv, g=g, hd=hd, page=page,
                          quantized=quantized, gen=gen)


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
