"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA card and skips
without one; this file imports no JAX, so on a machine with a card and no
JAX it runs alone:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_gpu.py

Tolerances: qmm fp32 max abs error <= 1e-4 * max|y| (the same fp32
products summed in another order), bf16 <= 1e-2 * max|y| (one bf16 ulp is
2^-8 of the value); attention atol 1e-5 / rtol 1e-4 on the fp32 outputs,
for fp32, int8 and bf16 pages alike (bf16 q and pages are widened exactly
by both versions, and the kernel keeps fp32 accuracy), rows at or past
kv_len exactly 0; unpack3b bit-exact. The serving step set's CUDA graphs
against the same steps run eagerly: tokens identical, logprobs and K/V
pages within 1e-5. The sampling head on the card against the CPU's:
threefry bits and uniforms bit-exact, gumbel values within 2e-6 (two
``log`` implementations), tokens identical where no float boundary is
within 1e-4 (checked). Hybrid and SSM stacks: attention at hymba-1.5b's
shapes (G = 5, window 1024) to the attention tolerances, a captured hybrid
step against the eager one (tokens identical, logprobs and SSM / conv
rows within 1e-5), slot reuse graphed and pipelined against a fresh
engine (tokens identical), the decode qmm launched on replay on a mamba
stack. MoE stacks: the MoE block captured in a CUDA graph and replayed 3
times bit-identical to its eager call (the combine sums in a fixed
order), its expert products through the qmm kernels (E x 3 launches a
call, decode-width and column-strip) within 1e-4 * max|y| of the plain
versions, a MoE step under the sync debugger and graphed against eager
(tokens identical, logprobs within 1e-5), attention at dbrx-132b's
hd 128 and G = 6 on every page kind, and at stablelm-3b's hd 80 and
gemma2-2b's hd 256 (G = 2, window, softcap 50), the Python count of the
kernel's shared memory against the library's; one ``decode_step`` of
reduced whisper-medium and internvl2-2b through the kernels against the
plain versions, logits within 1e-3 * max|logits|. The attention kernel
over a page slice (a data rank's) at hd 80, 128 and 256 on every page
kind against the sliced plain version (attention tolerances), the
slices merged against the whole-arena call, and the whole-arena slice
bit-identical to a call without one; over 2 slices at hymba-1.5b's shapes
(G = 5, window 1024). bf16 q over bf16 pages on the bf16-mma route (the
route counter says so) at hd 32, 64, 80, 128 and 256 and G 1, 2, 5, 6 and
8, on both paths, with and without window and softcap and over 2 page
slices; the walk from the window's first page at its edges (a floor mid-
page and on a page boundary, spans cut off the page-0 grid, window 1, a
window past kv_len) on every page kind, sliced too, and on every windowed
case NaN in the pages before a lane's window leaves the output's bits as
they were (no page before the window is read). The serving mesh's MoE
rank (expert parallelism at M = 2): its experts' products through the qmm
kernels, one ``moe`` sum,
the two ranks' partial outputs adding up to the whole block's within
1e-4 * max|y|. The training mesh's collectives with gradients on CUDA
tensors over gloo: reduced dbrx-132b (expert parallelism, capacity and
aux over the dp ranks) and mamba2-370m (the gathered ``in_proj``, the
split into ``out_proj``) at (2, 2) with 2 microbatches, step 0's
gradients against one process's on the card at rtol 1e-4 and atol 2e-6
* max|g| (``tests/test_torch_train_mesh_families.py``'s). A row split's
half batch through B2 and B3 planned on the whole batch (``plan_m``)
bit-identical to the whole batch's rows."""
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
from repro_torch.serve import sampling as samplib  # noqa: E402

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


def _decode_counters_zero():
    torch.cuda.synchronize()
    return all(int(c.abs().sum()) == 0 for c in kqmm._counters.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("pattern", ["all-inlier", "all-outlier",
                                     "checkerboard"])
@pytest.mark.parametrize("k,n", [(2048, 2048), (5632, 2048), (2048, 100352)],
                         ids=["many-splits", "K-5632", "one-split"])
@pytest.mark.parametrize("m", [8, 64, 120])
def test_decode_stream_patterns(gen, m, k, n, pattern, dtype):
    """The decode kernel on all-inlier, all-outlier and checkerboard
    weights: many K splits (N = 2048), a split whose subtile rows do not
    divide K's (K = 5632), and none (the 100352-wide lm_head); two calls
    bit-identical, one launch each, and the split tickets left at zero."""
    splits, rows = kqmm.decode_splits(m, k, n)
    assert (splits == 1) == (n == 100352)
    if k == 5632:
        assert (k // 8) % rows != 0 and splits > 1
    qt = _from_chip_smoke("patterned_qtensor")(k, n, pattern, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    build.reset_launches()
    y = kqmm.qmm_decode(x, qt)
    again = kqmm.qmm_decode(x, qt)
    want = qmm_ref(x, qt)
    torch.cuda.synchronize()
    assert build.launches["qmm_decode"] == 2
    assert y.dtype == dtype and y.shape == (m, n)
    assert torch.equal(y, again)                      # deterministic
    err = (y.float() - want.float()).abs().max().item()
    assert err <= QMM_TOL[dtype] * want.float().abs().max().item()
    assert _decode_counters_zero()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,route", [(8, "decode"), (64, "decode"),
                                     (128, "colstrip"), (512, "colstrip")])
def test_qmm_half_rows_under_the_global_plan(gen, m, route, dtype):
    """A data rank of a row split runs half a batch's rows through
    ``kernels.ops.qmm`` planned on the whole batch's (``plan_m``): the
    whole batch's route and K split, the half padded to the route's
    multiple (64 rows take the column strip at M = 128), and each half's
    rows bit-identical to the whole batch's; at decode width (M 8, 64:
    a 4-row half padded to 8) and at column-strip chunks (M 128, 512)."""
    k, n = 2048, 5632
    qt = _streams(k, n, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    kops.reset_path_counts()
    whole = kops.qmm(x, qt)
    assert kops.path_counts[route] == 1
    half = m // 2
    for part in (slice(0, half), slice(half, m)):
        kops.reset_path_counts()
        got = kops.qmm(x[part], qt, plan_m=m)
        torch.cuda.synchronize()
        assert kops.path_counts[route] == 1
        assert torch.equal(got, whole[part])
    assert _decode_counters_zero()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("k,n", [(2048, 5632), (2048, 100352)],
                         ids=["split", "one-split"])
def test_decode_zero_rows_change_no_result(gen, k, n, dtype):
    """A block skips the products of x rows that are zero in its slice of
    K. The rows that are not zeroed come out bit-identical to a call where
    no row is zero, and the zeroed rows exactly 0: rows 4-7 zero (M = 4
    padded to 8), rows 1-7 zero, rows 4-7 zero in the first half of K
    only, and x all zero."""
    qt = _streams(k, n, gen)
    full = torch.randn((8, k), generator=gen, device="cuda").to(dtype)
    y_full = kqmm.qmm_decode(full, qt)
    for rows, cols in ((slice(4, 8), slice(None)), (slice(1, 8), slice(None)),
                       (slice(4, 8), slice(0, k // 2)),
                       (slice(0, 8), slice(None))):
        x = full.clone()
        x[rows, cols] = 0
        y = kqmm.qmm_decode(x, qt)
        want = qmm_ref(x, qt)
        torch.cuda.synchronize()
        err = (y.float() - want.float()).abs().max().item()
        assert err <= QMM_TOL[dtype] * want.float().abs().max().item()
        kept = torch.ones(8, dtype=torch.bool, device="cuda")
        kept[rows] = False
        assert torch.equal(y[kept], y_full[kept])
        if cols == slice(None):
            assert not y[rows].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_decode_two_streams(gen, dtype):
    """Two calls on two streams with different x, each with its own split
    tickets, each equal to its own plain result."""
    qt = _streams(2048, 5632, gen)
    assert kqmm.decode_splits(8, 2048, 5632)[0] > 1
    xs = [torch.randn((8, 2048), generator=gen, device="cuda").to(dtype)
          for _ in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    ys = [[], []]
    for _ in range(4):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                ys[i].append(kqmm.qmm_decode(xs[i], qt))
    torch.cuda.synchronize()
    for i, st in enumerate(streams):
        assert (xs[i].device.index, st.cuda_stream) in kqmm._counters
        want = qmm_ref(xs[i], qt)
        err = (ys[i][0].float() - want.float()).abs().max().item()
        assert err <= QMM_TOL[dtype] * want.float().abs().max().item()
        assert all(torch.equal(ys[i][0], y) for y in ys[i][1:])
    assert _decode_counters_zero()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_decode_takes_scales_at_any_offset(gen, dtype):
    """The decode kernel reads the scales one float per thread, so scales
    4 bytes past a 16-byte boundary give the same bits as aligned ones."""
    qt = _streams(2048, 5632, gen)
    x = torch.randn((8, 2048), generator=gen, device="cuda").to(dtype)
    y = kqmm.qmm_decode(x, qt)
    for name in ("scale_in", "scale_out"):
        t = getattr(qt, name)
        moved = torch.empty(t.numel() + 1, device="cuda")[1:].view_as(t)
        moved.copy_(t)
        assert moved.data_ptr() % 16 == 4
        setattr(qt, name, moved)
    assert torch.equal(kqmm.qmm_decode(x, qt), y)


@pytest.mark.parametrize("rows", [0, kqmm.DECODE_MAX_ROWS + 1])
def test_decode_entry_refuses_rows_past_its_staging(gen, rows):
    """The C entry point returns an error, and launches nothing, for a K
    split whose subtile rows the kernel's x staging does not cover."""
    qt = _streams(2048, 2048, gen)
    x = torch.randn((8, 2048), generator=gen, device="cuda")
    y = torch.empty((8, 2048), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rc = build.library().qmc_qmm_decode(
        *kqmm._operands(x, qt), None, None, y.data_ptr(), 8, 2048, 2048, 1,
        rows, stream)
    with pytest.raises(RuntimeError, match="invalid argument"):
        build.check(rc, "qmm_decode")


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


def _attn_case(lanes, *, n_kv, g, hd, page, quantized, gen, bf16=False):
    return _from_chip_smoke("make_attn_case")(
        lanes, n_kv=n_kv, g=g, hd=hd, page=page, quantized=quantized,
        gen=gen, bf16=bf16)


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
                page=16, hd=64, bf16=False):
    """Kernel vs plain on one ragged case; returns the kernel's o. Rows at
    or past kv_len must be exactly 0 (m = -1e30, l = 0), two calls
    bit-identical; under a window, NaN in every page before a lane's
    window (``chip_smoke.poison_before_window``) leaves the output's bits
    as they were: the kernel walks from the window's first page."""
    q, cache, qs, kl, n_new, _ = _attn_case(
        lanes, n_kv=n_kv, g=g, hd=hd, page=page, quantized=quantized,
        gen=gen, bf16=bf16)
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
    if window is not None:
        bad, _ = _from_chip_smoke("poison_before_window")(cache, qs, window,
                                                          page)
        ob, mb, lb = ragged_paged_attention_call(q, bad, qs, kl, **kw)
        assert torch.equal(ob, o) and torch.equal(mb, m) \
            and torch.equal(lb, l)
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


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("path", ["decode", "chunk"])
@pytest.mark.parametrize("kv", [1, 17, 4096])
def test_attention_bf16_queries_and_pages(gen, kv, path, g):
    """bf16 q over bf16 pages on both paths, at kv_len 1, page + 1 and
    4096 (several spans), beside an idle lane."""
    if path == "decode":
        lanes = ((kv - 1, 1), (0, 0), (kv // 2, 1))
    else:
        n = min(16, kv)
        lanes = ((kv - n, n), (0, 0), (40, 16))
    _attn_check(lanes, n_kv=4, g=g, quantized=False, gen=gen, bf16=True)


def _sliced_check(q, cache, qs, kl, n_new, kw, slices=2):
    """The kernel over each of ``slices`` page slices (one launch each)
    against the sliced plain version (rows with no key in a slice exactly
    (0, -1e30, 0)), and the slices merged against the whole-arena call
    (dead rows 0)."""
    from repro_torch.kernels.paged_attention import merge_slices
    n_pages = cache["k_pages"].shape[0]
    bounds = [round(i * n_pages / slices) for i in range(slices + 1)]
    build.reset_launches()
    parts = []
    for a, b in zip(bounds, bounds[1:]):
        local = _local(cache, a, b - a)
        o, m, l = ragged_paged_attention_call(q, local, qs, kl,
                                              page_slice=(a, b - a), **kw)
        o_r, m_r, l_r = ragged_paged_attention_ref(
            q, local, qs, kl, page_slice=(a, b - a), **kw)
        torch.cuda.synchronize()
        live = l_r > 0
        assert (o[~live] == 0).all() and (l[~live] == 0).all()
        assert (m[~live] == -1e30).all()
        for got, want in ((o, o_r), (m, m_r), (l, l_r)):
            torch.testing.assert_close(got[live], want[live], atol=1e-5,
                                       rtol=1e-4)
        parts.append((o, m, l))
    assert build.launches["ragged_paged_attention"] == slices
    whole, _, _ = ragged_paged_attention_call(q, cache, qs, kl, **kw)
    valid = torch.arange(q.shape[1], device="cuda")[None, :] < n_new[:, None]
    merged = merge_slices(parts)
    torch.testing.assert_close(merged[valid], whole[valid], atol=1e-5,
                               rtol=1e-4)
    assert (merged[~valid] == 0).all()


@pytest.mark.parametrize("g", [1, 2, 5, 6, 8])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("path", ["decode", "chunk"])
def test_attention_bf16_mma_route(gen, path, hd, g):
    """bf16 q over bf16 pages takes the bf16-mma route (the route counter
    says so) at every head dim and G the kernels take, on both paths:
    without window and softcap, with both, and over 2 page slices with
    the window, against the plain version at the attention tolerances."""
    from repro_torch.kernels import paged_attention as kpa
    if path == "decode":
        lanes = ((300, 1), (0, 0), (17, 1), (95, 1))
    else:
        lanes = ((0, 40), (60, 16), (0, 0), (130, 1))
    before = kpa.route_launches["bf16-mma"]
    for window, cap in ((None, None), (40, 30.0)):
        _attn_check(lanes, n_kv=2, g=g, hd=hd, quantized=False, gen=gen,
                    bf16=True, window=window, cap=cap)
    assert kpa.route_launches["bf16-mma"] - before == 2 * 2 + 1
    q, cache, qs, kl, n_new, _ = _attn_case(
        lanes, n_kv=2, g=g, hd=hd, page=16, quantized=False, gen=gen,
        bf16=True)
    _from_chip_smoke("in_order")(cache)
    _sliced_check(q, cache, qs, kl, n_new,
                  dict(n_kv=2, head_dim=hd, window=40, attn_softcap=30.0))


@pytest.mark.parametrize("edge", ["mid-page", "page-boundary",
                                  "straddles-spans", "window-1",
                                  "past-kv_len"])
@pytest.mark.parametrize("path", ["decode", "chunk"])
@pytest.mark.parametrize("pages", ["fp32", "int8", "bf16"])
def test_attention_window_floor_edges(gen, pages, path, edge):
    """The walk from the window's first page: lane 0's first query at 100
    sees keys from 71 (mid-page 4) or from 64 (page 4's first key); a
    window of 120 floors lane 1 mid-way through page 5, so that its
    spans of 4 pages (one KV head) start off the page-0 grid; a window of
    1 (each row sees itself), and one past every kv_len. Against the
    plain version, with NaN in the pages before each lane's window
    (``_attn_check``), and over 2 page slices numbered as the pool hands
    them out (a run straddling the floor starts at it)."""
    window = {"mid-page": 30, "page-boundary": 37, "straddles-spans": 120,
              "window-1": 1, "past-kv_len": 10_000}[edge]
    if path == "decode":
        lanes = ((100, 1), (215, 1), (0, 0), (39, 1))
    else:
        lanes = ((100, 16), (200, 16), (0, 0), (37, 3))
    kw = dict(n_kv=1, g=2, quantized=pages == "int8", gen=gen,
              bf16=pages == "bf16")
    _attn_check(lanes, window=window, **kw)
    q, cache, qs, kl, n_new, _ = _attn_case(
        lanes, n_kv=1, g=2, hd=64, page=16, quantized=pages == "int8",
        gen=gen, bf16=pages == "bf16")
    _from_chip_smoke("in_order")(cache)
    _sliced_check(q, cache, qs, kl, n_new,
                  dict(n_kv=1, head_dim=64, window=window))


@pytest.mark.parametrize("q_bf16", [False, True], ids=["fp32q", "bf16q"])
@pytest.mark.parametrize("lanes", [((69, 1), (5, 1)), ((0, 40), (16, 3))],
                         ids=["decode", "chunk"])
def test_attention_mixed_dtypes_and_public_dtype(gen, lanes, q_bf16):
    """q and the pages in different dtypes (bf16 q over fp32 pages, fp32 q
    over bf16 pages); the public wrapper returns o in q's dtype."""
    from repro_torch.kernels.paged_attention import ragged_paged_attention
    q, cache, qs, kl, n_new, _ = _attn_case(
        lanes, n_kv=2, g=2, hd=64, page=16, quantized=False, gen=gen)
    if q_bf16:
        q = q.bfloat16()
    else:
        cache = dict(cache, k_pages=cache["k_pages"].bfloat16(),
                     v_pages=cache["v_pages"].bfloat16())
    kw = dict(n_kv=2, head_dim=64)
    o, m, l = ragged_paged_attention_call(q, cache, qs, kl, **kw)
    o_r, m_r, l_r = ragged_paged_attention_ref(q, cache, qs, kl, **kw)
    assert o.dtype == torch.float32
    valid = torch.arange(q.shape[1], device="cuda")[None, :] < n_new[:, None]
    for got, want in ((o, o_r), (m, m_r), (l, l_r)):
        torch.testing.assert_close(got[valid], want[valid], atol=1e-5,
                                   rtol=1e-4)
    pub = ragged_paged_attention(q, cache, qs, kl, **kw)
    assert pub.dtype == q.dtype
    assert torch.equal(pub, o.to(q.dtype))


def test_attention_wrapper_refuses_fp16_queries_and_pages(gen):
    """What the kernel does not take: fp16 q, fp16 pages, int8 pages
    without their scales."""
    q, cache, qs, kl, _, _ = _attn_case(((0, 4),), n_kv=2, g=1, hd=64,
                                        page=16, quantized=False, gen=gen)
    kw = dict(n_kv=2, head_dim=64)
    with pytest.raises(TypeError):
        ragged_paged_attention_call(q.half(), cache, qs, kl, **kw)
    half = dict(cache, k_pages=cache["k_pages"].half(),
                v_pages=cache["v_pages"].half())
    with pytest.raises(TypeError):
        ragged_paged_attention_call(q, half, qs, kl, **kw)
    codes = dict(cache, k_pages=cache["k_pages"].to(torch.int8),
                 v_pages=cache["v_pages"].to(torch.int8))
    with pytest.raises(TypeError):
        ragged_paged_attention_call(q, codes, qs, kl, **kw)


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


# ---------------------------------------------------------------------------
# the serving step set: one CUDA graph per token width
# ---------------------------------------------------------------------------
def _graph_model():
    """Two layers whose every projection the qmm kernels take (K, N
    multiples of 128), hd 64 (both attention paths), GQA 2."""
    from repro_torch.core.serving_quant import quantize_for_serving
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import init_params
    cfg = ModelConfig(name="g", family="dense", n_layers=2, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=512, vocab=1024)
    params = quantize_for_serving(init_params(cfg, 0, device="cuda"),
                                  QMCConfig(rho=0.3, granularity="subtile"),
                                  min_dim=64)
    return cfg, params


def _step_set(cfg, graphs):
    from repro_torch.serve import steps as serve_steps
    from repro_torch.serve.paged_kv import PagedKVPool
    pool = PagedKVPool(cfg, n_pages=16, page=16, max_slots=4,
                       max_pages_per_seq=4, device="cuda")
    arena = pool.init_arena()
    for s in range(3):
        pool.ensure(s, 60)
    sset = serve_steps.build_paged_steps(
        cfg, page=16, n_pages=16, max_slots=4, max_pages_per_seq=4,
        cache_dtype=torch.float32, chunk=64, device="cuda",
        cuda_graphs=graphs)
    sset.apply_page_ops(arena, pool.block_tables)
    return sset, arena


def test_graphed_step_matches_eager_step(gen):
    """A prefill rung (C = 16) and two C = 1 decode rounds, then a solo
    round, through graphs and eagerly from the same arena: identical
    tokens; the replays count their launches; the decode qmm's tickets
    are zero afterwards."""
    import numpy as np
    cfg, params = _graph_model()
    rng = np.random.default_rng(0)
    rounds = [(rng.integers(2, 1024, (4, 16)), [0, 0, 0, 0],
               [16, 9, 16, 0]),
              (rng.integers(2, 1024, (4, 1)), [16, 9, 16, 0], [1, 1, 1, 0]),
              (rng.integers(2, 1024, (4, 1)), [17, 10, 17, 0],
               [1, 1, 0, 0])]
    runs = {}
    for graphs in (False, True):
        sset, arena = _step_set(cfg, graphs)
        outs = []
        for i, (toks, start, n_new) in enumerate(rounds):
            # a width's first graphed call also runs its warm-up
            first_use = graphs and i < 2
            build.reset_launches()
            kops.reset_path_counts()
            tok, logp = sset.step(params, toks.astype(np.int32), arena,
                                  np.array(start, np.int32),
                                  np.array(n_new, np.int32),
                                  samplib.lane_inputs(4))
            outs.append((tok.clone(), logp.clone()))
            torch.cuda.synchronize()
            assert build.launches["ragged_paged_attention"] == \
                (4 if first_use else 2)
            assert build.launches["qmm_decode"] > 0 \
                or build.launches["qmm_colstrip"] > 0
            assert kops.path_counts["ref"] == 0
        tok, logp = sset.solo_step(params, np.array([[7]], np.int32), arena,
                                   np.array([18], np.int32),
                                   np.array([1], np.int32),
                                   samplib.lane_inputs(1), slot=0)
        outs.append((tok.clone(), logp.clone()))
        torch.cuda.synchronize()
        runs[graphs] = (outs, arena, sset)
    (eager, a_e, s_e), (graphed, a_g, s_g) = runs[False], runs[True]
    assert s_e.capture_counters()[1] == 0
    assert s_g.step.captures == 2 and s_g.solo_step.captures == 1
    assert s_g.step.replays == 3 and s_g.pool_bytes > 0
    for (te, le), (tg, lg) in zip(eager, graphed):
        assert torch.equal(te, tg)
        torch.testing.assert_close(lg, le, atol=1e-5, rtol=1e-5)
    for key in a_e:
        for name in ("k_pages", "v_pages"):    # page 0, the null page,
            torch.testing.assert_close(          # holds idle lanes' writes
                a_g[key]["attn"][name][:, 1:],
                a_e[key]["attn"][name][:, 1:], atol=1e-5, rtol=1e-5)
    assert _decode_counters_zero()


def test_eager_step_reads_nothing_back_from_the_device(gen):
    """The step a graph captures, run eagerly under the sync debugger,
    with the greedy head and with a sampled lane seated: no read of the
    device from the host anywhere in it."""
    import numpy as np
    cfg, params = _graph_model()
    sset, arena = _step_set(cfg, False)
    z = np.zeros(4, np.int32)
    hot = samplib.lane_inputs(4)
    samplib.set_lane(hot, 1, samplib.SamplingParams(
        temperature=0.8, top_k=50, top_p=0.9, seed=1), uid=3)
    sset.step(params, np.zeros((4, 1), np.int32), arena, z, z, hot)
    sset.step(params, np.ones((4, 16), np.int32), arena, z,
              np.array([16, 3, 0, 1], np.int32), hot)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sset.step(params, np.ones((4, 16), np.int32), arena, z,
                  np.array([16, 3, 0, 1], np.int32), samplib.lane_inputs(4))
        sset.step(params, np.ones((4, 16), np.int32), arena, z,
                  np.array([16, 3, 0, 1], np.int32), hot)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_engine_graphed_and_pipelined_tokens_match_eager(gen):
    """Seven requests through three slots: eager, graphed, graphed and
    pipelined give identical tokens; captures stay within the declared
    surface."""
    import numpy as np
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, params = _graph_model()

    def reqs():
        rng = np.random.default_rng(4)
        return [Request(uid=i, prompt=rng.integers(2, 1024, int(n)).astype(
            np.int32), max_new_tokens=int(m))
            for i, (n, m) in enumerate(zip(rng.integers(3, 60, 7),
                                           rng.integers(2, 12, 7)))]

    outs = []
    for kw in (dict(cuda_graphs=False), dict(cuda_graphs=True),
               dict(cuda_graphs=True, pipelined=True)):
        eng = ServeEngine(cfg, params, slots=3, max_len=64, page_size=16,
                          device="cuda", **kw)
        outs.append([r.out_tokens for r in eng.run(reqs())])
        sset = eng.step_set
        for fn in (sset.step, sset.solo_step):
            assert fn.captures <= len(fn.widths)
        if kw["cuda_graphs"]:
            assert eng.stats.graph_replays == eng.stats.rounds
    assert outs[0] == outs[1] == outs[2]


# ---------------------------------------------------------------------------
# sampled lanes, the prefix cache and speculative decode on the card
# ---------------------------------------------------------------------------
def _keys(n, seed=3):
    import numpy as np
    return np.stack([samplib.request_key(seed, u) for u in range(n)]
                    ).view(np.int32)


def test_threefry_bits_on_the_card_equal_the_cpu(gen):
    keys = torch.from_numpy(_keys(5))
    for n in (1, 1001, 100352):
        cpu = samplib.random_bits(keys, n)
        card = samplib.random_bits(keys.cuda(), n)
        assert torch.equal(card.cpu(), cpu)
        assert torch.equal(samplib.uniform_from_bits(card).cpu(),
                           samplib.uniform_from_bits(cpu))
        torch.testing.assert_close(samplib.gumbel_from_bits(card).cpu(),
                                   samplib.gumbel_from_bits(cpu),
                                   atol=2e-6, rtol=1e-6)
    pos = torch.arange(0, 4096, 37, dtype=torch.int32)
    k = keys[0]
    z = torch.zeros_like(pos)
    cpu = samplib.threefry2x32(k[0], k[1], z, pos)
    card = samplib.threefry2x32(k[0].cuda(), k[1].cuda(), z.cuda(),
                                pos.cuda())
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))


def test_select_tokens_on_the_card_equals_the_cpu(gen):
    """Mixed lanes (greedy, temperature, top-k, top-p, both) over a
    4096-token vocab: the card's tokens are the CPU's. Both float
    boundaries (each row's top-p cumulative mass against p, the winning
    masked+gumbel score against the runner-up) are checked to be more
    than 1e-5 away on these logits, past where two devices' sums may
    round apart (~1e-6)."""
    _select_tokens_card_vs_cpu(gen, 4096)


def test_select_tokens_at_an_odd_vocab_on_the_card(gen):
    """The same at hymba-1.5b's vocab, 32001: an odd row length for the
    head's sorts, cumulative sums and threefry counters."""
    _select_tokens_card_vs_cpu(gen, 32001)


def _select_tokens_card_vs_cpu(gen, v):
    b, c = 5, 8
    lg = torch.randn((b, c, v), generator=gen, device="cuda") * 3
    temp = torch.tensor([0.0, 0.7, 1.3, 0.9, 0.5])
    top_k = torch.tensor([0, 0, 50, 0, 8], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 1.0, 0.8, 0.6])
    key = torch.from_numpy(_keys(b))
    pos = (torch.arange(b, dtype=torch.int32)[:, None] * 19
           + torch.arange(c, dtype=torch.int32)[None])
    n_new = torch.tensor([c, 3, c, c, 1], dtype=torch.int32)
    args = (temp, top_k, top_p, key, pos, n_new)
    want_t, want_l = samplib.select_tokens(lg.cpu(), *args)
    got_t, got_l = samplib.select_tokens(lg, *[a.cuda() for a in args])
    # the margins, in float64 from the CPU's logits and gumbel draws
    s = (lg.cpu() / temp.clamp_min(1e-6)[:, None, None]).double()
    desc = torch.sort(s, -1, descending=True).values
    cum = torch.cumsum(torch.softmax(desc, -1), -1)
    hot = top_p < 1
    assert float((cum[hot] - top_p[hot, None, None]).abs().min()) > 1e-5
    kth = desc.gather(-1, (top_k.clamp(1, v) - 1).long()[:, None, None]
                      .expand(b, c, 1))
    n_keep = (cum < top_p[:, None, None]).sum(-1, keepdim=True)
    pth = desc.gather(-1, n_keep.clamp_max(v - 1))
    keep = (((s >= kth) | (top_k <= 0)[:, None, None])
            & ((s >= pth) | ~hot[:, None, None]))
    kc = torch.stack(samplib.threefry2x32(
        key[:, None, 0].expand(b, c).reshape(-1),
        key[:, None, 1].expand(b, c).reshape(-1),
        torch.zeros(b * c, dtype=torch.int32), pos.reshape(-1)), -1)
    g = samplib.gumbel_from_bits(samplib.random_bits(kc, v)).view(b, c, v)
    score = torch.where(keep, s + g.double(), -torch.inf).sort(-1).values
    gap = (score[..., -1] - score[..., -2])[temp > 0]
    assert float(gap[torch.isfinite(gap)].min()) > 1e-5
    assert torch.equal(got_t.cpu(), want_t)
    torch.testing.assert_close(got_l.cpu(), want_l, atol=1e-5, rtol=1e-5)


def test_graphed_sampled_steps_match_eager(gen):
    """Sampled lanes through the step set's graphs and eagerly, from the
    same arena: identical tokens; the graphed set holds a greedy and a
    sampled graph for the width that ran both."""
    import numpy as np
    cfg, params = _graph_model()
    samp = samplib.lane_inputs(4)
    for s, sp in ((0, samplib.SamplingParams(temperature=0.8, top_k=50,
                                             top_p=0.95, seed=5)),
                  (2, samplib.SamplingParams(temperature=1.2, seed=6))):
        samplib.set_lane(samp, s, sp, uid=s + 10)
    rng = np.random.default_rng(1)
    rounds = [(rng.integers(2, 1024, (4, 16)), [0, 0, 0, 0],
               [16, 9, 16, 0], samp),
              (rng.integers(2, 1024, (4, 1)), [16, 9, 16, 0], [1, 1, 1, 0],
               samp),
              (rng.integers(2, 1024, (4, 1)), [17, 10, 17, 0], [0, 1, 0, 0],
               samp),
              (rng.integers(2, 1024, (4, 1)), [17, 11, 17, 0], [1, 1, 1, 0],
               samplib.lane_inputs(4))]
    runs = {}
    for graphs in (False, True):
        sset, arena = _step_set(cfg, graphs)
        outs = []
        for toks, start, n_new, sp in rounds:
            tok, logp = sset.step(params, toks.astype(np.int32), arena,
                                  np.array(start, np.int32),
                                  np.array(n_new, np.int32), sp)
            outs.append((tok.clone(), logp.clone()))
        torch.cuda.synchronize()
        runs[graphs] = (outs, sset)
    (eager, _), (graphed, s_g) = runs[False], runs[True]
    assert s_g.step.captures == 3 <= s_g.step.surface
    for (te, le), (tg, lg) in zip(eager, graphed):
        assert torch.equal(te, tg)
        torch.testing.assert_close(lg, le, atol=1e-5, rtol=1e-5)


def test_page_copy_is_in_place(gen):
    """apply_page_ops copies pages into the arena's own tensors: every
    leaf keeps its address, the destination pages hold the sources'
    contents, and the rest is untouched."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve import steps as serve_steps
    from repro_torch.serve.paged_kv import PagedKVPool
    for quant in (False, True):
        cfg = ModelConfig(name="g", family="dense", n_layers=2, d_model=256,
                          n_heads=4, n_kv_heads=2, d_ff=512, vocab=1024,
                          kv_cache_quant=quant)
        pool = PagedKVPool(cfg, n_pages=12, page=16, max_slots=4,
                           max_pages_per_seq=3, device="cuda")
        arena = pool.init_arena()
        for grp in arena.values():
            for name, leaf in grp["attn"].items():
                if name.endswith("_pages"):
                    leaf.copy_(torch.randint(-100, 100, leaf.shape,
                                             generator=gen, device="cuda"))
        ptrs = {(k, n): t.data_ptr() for k, g in arena.items()
                for n, t in g["attn"].items()}
        before = {(k, n): t.clone() for k, g in arena.items()
                  for n, t in g["attn"].items()}
        ops = serve_steps.build_paged_steps(
            cfg, page=16, n_pages=12, max_slots=4, max_pages_per_seq=3,
            cache_dtype=torch.float32, device="cuda").apply_page_ops
        pool.ensure(0, 40)
        ops(arena, pool.block_tables, [(2, 7), (3, 9)])
        torch.cuda.synchronize()
        for (k, n), t in ((kn, arena[kn[0]]["attn"][kn[1]]) for kn in ptrs):
            assert t.data_ptr() == ptrs[(k, n)]
            if not n.endswith("_pages"):
                continue
            want = before[(k, n)].clone()
            want[:, 7], want[:, 9] = want[:, 2], want[:, 3]
            assert torch.equal(t, want)
        assert torch.equal(arena["b0"]["attn"]["block_tbl"][0].cpu(),
                           torch.from_numpy(pool.block_tables))


def test_engine_cache_and_speculative_graphed_eager_pipelined_match(gen):
    """Prefix cache (shared prefix, an identical page-aligned pair that
    dedups and COWs) and speculative decode (k = 4 over repeating
    prompts), each eager, graphed, graphed and pipelined: identical
    tokens, equal to the uncached / non-speculative run."""
    import numpy as np
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, params = _graph_model()
    rng = np.random.default_rng(8)
    shared = rng.integers(2, 1024, 32)
    pair = rng.integers(2, 1024, 48)
    phrase = rng.integers(2, 1024, 8)

    def cached():
        r = np.random.default_rng(9)
        return [Request(uid=i, prompt=np.concatenate(
            [shared, r.integers(2, 1024, int(r.integers(3, 20)))]).astype(
                np.int32), max_new_tokens=6) for i in range(5)] + [
            Request(uid=5 + i, prompt=pair.astype(np.int32),
                    max_new_tokens=6) for i in range(2)]

    def repeating():
        return [Request(uid=i, prompt=np.tile(np.roll(phrase, i), 4).astype(
            np.int32), max_new_tokens=12) for i in range(3)]

    for make, feat in ((cached, dict(prefix_cache=True)),
                       (repeating, dict(speculative_k=4))):
        base = ServeEngine(cfg, params, slots=3, max_len=96, page_size=16,
                           device="cuda").run(make())
        want = [r.out_tokens for r in base]
        for kw in (dict(cuda_graphs=False), dict(cuda_graphs=True),
                   dict(cuda_graphs=True, pipelined=True)):
            eng = ServeEngine(cfg, params, slots=3, max_len=96, page_size=16,
                              device="cuda", **feat, **kw)
            assert [r.out_tokens for r in eng.run(make())] == want, kw
            if "prefix_cache" in feat:
                assert eng.stats.cache_hit_tokens > 0
                assert eng.stats.cow_copies >= 1
            else:
                assert eng.stats.spec_rounds > 0
            for fn in (eng.step_set.step, eng.step_set.solo_step):
                assert fn.captures <= len(fn.widths)


# ---------------------------------------------------------------------------
# observability on the card: spans, readback, cost capture
# ---------------------------------------------------------------------------
def _obs_requests():
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(4)
    return [Request(uid=i, prompt=rng.integers(2, 1024, int(n)).astype(
        np.int32), max_new_tokens=int(m))
        for i, (n, m) in enumerate(zip(rng.integers(3, 60, 7),
                                       rng.integers(2, 12, 7)))]


def test_traced_graphed_engine_matches_untraced(gen):
    """A graphed engine with an enabled tracer and its own registry gives
    the untraced engine's tokens; the trace holds one ``round`` span and
    one ``req/first_token`` per request, and the registry the run's
    rounds."""
    from repro_torch.obs.metrics import Registry
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.engine import ServeEngine
    cfg, params = _graph_model()
    plain = ServeEngine(cfg, params, slots=3, max_len=64, page_size=16,
                        device="cuda").run(_obs_requests())
    for pipelined in (False, True):
        trc, reg = Tracer(), Registry()
        eng = ServeEngine(cfg, params, slots=3, max_len=64, page_size=16,
                          device="cuda", pipelined=pipelined, tracer=trc,
                          metrics=reg)
        out = eng.run(_obs_requests())
        assert [r.out_tokens for r in out] == [r.out_tokens for r in plain]
        names = [e["name"] for e in trc.events]
        assert names.count("round") == eng.stats.rounds
        assert sorted(e["args"]["uid"] for e in trc.events
                      if e["name"] == "req/first_token") == list(range(7))
        assert reg.counter("serve_rounds_total").value() == eng.stats.rounds


def test_device_step_span_covers_the_readback(gen, monkeypatch):
    """On the card ``round/device_step`` closes after the readback event:
    the spans' sum is at least the CUDA-event time of the graph replays
    they launched (a span closed at the enqueue would hold ~0.1 ms a
    round)."""
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.engine import ServeEngine
    cfg, params = _graph_model()
    trc = Tracer()
    eng = ServeEngine(cfg, params, slots=3, max_len=64, page_size=16,
                      device="cuda", tracer=trc)
    eng.run(_obs_requests())                       # captures every width
    trc.clear()
    timed = []
    replay = torch.cuda.CUDAGraph.replay

    def timed_replay(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        replay(self)
        b.record()
        timed.append((a, b))

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", timed_replay)
    eng.run(_obs_requests())
    torch.cuda.synchronize()
    assert len(timed) == eng.stats.rounds == eng.stats.graph_replays
    replay_ms = sum(a.elapsed_time(b) for a, b in timed)
    span_ms = sum(e["dur"] for e in trc.events
                  if e["name"] == "round/device_step") / 1e3
    assert span_ms >= replay_ms > 0, (span_ms, replay_ms)


def test_cost_captured_run_attributes_one_dispatch_per_round(gen):
    from repro_torch.obs import costs as obs_costs
    from repro_torch.obs.metrics import Registry
    from repro_torch.serve.engine import ServeEngine
    cfg, params = _graph_model()
    prev = obs_costs.enable_capture()
    try:
        for pipelined in (False, True):
            eng = ServeEngine(cfg, params, slots=3, max_len=64,
                              page_size=16, device="cuda",
                              pipelined=pipelined, metrics=Registry())
            eng.run(_obs_requests())
            eng.run(_obs_requests())               # warm: no capture
            assert eng.stats.graph_captures == 0
            rows = [r for r in eng.last_cost_report.fns
                    if r.fn in ("step", "solo_step")]
            assert sum(r.calls for r in rows) == eng.stats.rounds
            assert all(r.captured and r.drift > 1 for r in rows)
    finally:
        obs_costs.enable_capture(prev)


@pytest.mark.parametrize("capture", [False, True], ids=["trace",
                                                        "trace+cost"])
def test_step_reads_nothing_back_with_the_tracer_on(gen, capture):
    """The graphed step (replay) and the eager step under the sync
    debugger with the process tracer on, and with cost capture on (whose
    timed window closes with ``torch.cuda.synchronize()``)."""
    import numpy as np
    from repro_torch.obs import costs as obs_costs
    from repro_torch.obs import trace as obs_trace
    cfg, params = _graph_model()
    trc = obs_trace.Tracer()
    prev_t = obs_trace.set_tracer(trc)
    prev_c = obs_costs.enable_capture(capture)
    try:
        for graphs in (False, True):
            sset, arena = _step_set(cfg, graphs)
            z = np.zeros(4, np.int32)
            args = (params, np.zeros((4, 1), np.int32), arena, z,
                    np.array([1, 1, 0, 0], np.int32), samplib.lane_inputs(4))
            sset.step(*args)                       # capture / create
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                sset.step(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    finally:
        obs_trace.set_tracer(prev_t)
        obs_costs.enable_capture(prev_c)
    assert [e for e in trc.events if e["name"] == "jit/compile"]
    assert bool([e for e in trc.events if e["name"] == "cost/step"]) \
        == capture


# ---------------------------------------------------------------------------
# hybrid and SSM stacks: attention at hymba-1.5b's shapes, the Mamba2 state
# under CUDA graphs, slot reuse, the qmm on an SSM stack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pages", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("path", ["decode", "chunk"])
def test_attention_hymba_shapes_g5_window(gen, path, pages):
    """hymba-1.5b's attention: 5 KV heads of 25 query heads (G = 5, not a
    power of two: a q block's rows cross m-tile boundaries), hd 64, the
    1024-token window of its ``hybrid_local`` layers, kv_len up to 2048
    (past the window) beside an idle lane, on both paths."""
    if path == "decode":
        lanes = ((2047, 1), (1500, 1), (0, 0), (1030, 1))
    else:
        lanes = ((1100, 128), (1500, 100), (0, 0), (2047, 1))
    for window in (1024, None):
        _attn_check(lanes, n_kv=5, g=5, quantized=pages == "int8", gen=gen,
                    window=window, bf16=pages == "bf16")


def _hybrid_model(pattern=("hybrid", "hybrid_local")):
    """A hybrid (or mamba, ``pattern=("mamba",)``) stack whose QTensor
    leaves the qmm kernels take: w_up / w_gate 256 x 512 and the mixer's
    out_proj 512 x 256 (in_proj, 256 x 1072, stays dense)."""
    from repro_torch.core.serving_quant import quantize_for_serving
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import init_params
    attn = pattern != ("mamba",)
    cfg = ModelConfig(name="h", family="hybrid" if attn else "ssm",
                      n_layers=2, d_model=256, n_heads=4 if attn else 0,
                      n_kv_heads=2 if attn else 0,
                      head_dim=0 if attn else 1, d_ff=512 if attn else 0,
                      vocab=1024, pattern=pattern, window=32, d_state=16,
                      ssm_headdim=32)
    params = quantize_for_serving(init_params(cfg, 0, device="cuda"),
                                  QMCConfig(rho=0.3, granularity="subtile"),
                                  min_dim=64)
    return cfg, params


def test_graphed_hybrid_step_matches_eager_step(gen):
    """A chunk round (C = 16, one lane idle), two decode rounds and a solo
    round of a hybrid stack, through graphs and eagerly from the same
    arena: identical tokens, logprobs and the arena's SSM / conv rows
    within 1e-5, the idle lane's rows still zero. A captured step that
    rebound the state instead of writing it in place would replay against
    the state of its capture and fail here."""
    import numpy as np
    cfg, params = _hybrid_model()
    rng = np.random.default_rng(0)
    rounds = [(rng.integers(2, 1024, (4, 16)), [0, 0, 0, 0],
               [16, 9, 16, 0]),
              (rng.integers(2, 1024, (4, 1)), [16, 9, 16, 0], [1, 1, 1, 0]),
              (rng.integers(2, 1024, (4, 1)), [17, 10, 17, 0],
               [1, 1, 0, 0])]
    runs = {}
    for graphs in (False, True):
        sset, arena = _step_set(cfg, graphs)
        ptrs = {k: g["mamba"]["ssm"].data_ptr() for k, g in arena.items()}
        outs = []
        for toks, start, n_new in rounds:
            tok, logp = sset.step(params, toks.astype(np.int32), arena,
                                  np.array(start, np.int32),
                                  np.array(n_new, np.int32),
                                  samplib.lane_inputs(4))
            outs.append((tok.clone(), logp.clone()))
        tok, logp = sset.solo_step(params, np.array([[7]], np.int32), arena,
                                   np.array([18], np.int32),
                                   np.array([1], np.int32),
                                   samplib.lane_inputs(1), slot=0)
        outs.append((tok.clone(), logp.clone()))
        torch.cuda.synchronize()
        assert ptrs == {k: g["mamba"]["ssm"].data_ptr()
                        for k, g in arena.items()}
        runs[graphs] = (outs, arena)
    (eager, a_e), (graphed, a_g) = runs[False], runs[True]
    for (te, le), (tg, lg) in zip(eager, graphed):
        assert torch.equal(te, tg)
        torch.testing.assert_close(lg, le, atol=1e-5, rtol=1e-5)
    for key in a_e:
        for name in ("ssm", "conv"):
            got, want = a_g[key]["mamba"][name], a_e[key]["mamba"][name]
            assert want[:, :3].abs().max() > 0          # the state moved
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            assert not got[:, 3].any()                  # idle lane 3


def _hybrid_requests(n, seed=4):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(2, 1024, int(p)).astype(
        np.int32), max_new_tokens=int(m))
        for i, (p, m) in enumerate(zip(rng.integers(3, 60, n),
                                       rng.integers(4, 12, n)))]


def test_hybrid_reused_slot_graphed_pipelined_matches_fresh_engine(gen):
    """Five requests through two slots, graphed and pipelined: every
    request seated into a slot an earlier one used (its state reset rides
    in the page-ops upload) gets the tokens a fresh engine gives it
    alone, and the eager engine's."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, params = _hybrid_model()
    kw = dict(slots=2, max_len=96, page_size=16, device="cuda")
    reqs = ServeEngine(cfg, params, cuda_graphs=True, pipelined=True,
                       **kw).run(_hybrid_requests(5))
    eager = ServeEngine(cfg, params, cuda_graphs=False,
                        **kw).run(_hybrid_requests(5))
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in eager]
    for r in reqs[2:]:
        fresh = ServeEngine(cfg, params, cuda_graphs=True, pipelined=True,
                            **kw)
        alone = fresh.run([Request(uid=r.uid, prompt=r.prompt,
                                   max_new_tokens=r.max_new_tokens)])
        assert alone[0].out_tokens == r.out_tokens, r.uid


def test_mamba_engine_launches_decode_qmm_on_replay(gen):
    """An attention-free stack, graphed: the measured run (graphs captured
    by a first run) replays every round and launches the decode-width
    qmm on the mixer's out_proj, never its plain version; tokens equal
    the eager engine's."""
    from repro_torch.serve.engine import ServeEngine
    cfg, params = _hybrid_model(("mamba",))
    kw = dict(slots=3, max_len=96, page_size=16, device="cuda")
    eng = ServeEngine(cfg, params, cuda_graphs=True, **kw)
    eng.run(_hybrid_requests(6))
    build.reset_launches()
    kops.reset_path_counts()
    got = eng.run(_hybrid_requests(6))
    torch.cuda.synchronize()
    assert eng.stats.graph_captures == 0
    assert eng.stats.graph_replays == eng.stats.rounds > 0
    assert build.launches["qmm_decode"] > 0
    assert kops.path_counts["decode"] > 0 and kops.path_counts["ref"] == 0
    assert build.launches["ragged_paged_attention"] == 0
    eager = ServeEngine(cfg, params, cuda_graphs=False,
                        **kw).run(_hybrid_requests(6))
    assert [r.out_tokens for r in got] == [r.out_tokens for r in eager]


# ---------------------------------------------------------------------------
# MoE stacks and the contiguous-cache surface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pages", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("path", ["decode", "chunk"])
def test_attention_dbrx_shapes_hd128_g6(gen, path, pages):
    """dbrx-132b's attention: hd 128, 6 query heads a KV head (2 KV heads
    here, 8 in the model). A 16-token q block over fp32 pages needs more
    shared memory than a block may have at these shapes, so the wrapper
    runs 8-token blocks there; every page kind against the plain
    version, chunk and decode lanes beside an idle one."""
    if path == "decode":
        lanes = ((255, 1), (100, 1), (0, 0), (17, 1))
    else:
        lanes = ((0, 192), (64, 100), (0, 0), (33, 1))
    _attn_check(lanes, n_kv=2, g=6, hd=128, quantized=pages == "int8",
                gen=gen, bf16=pages == "bf16")


@pytest.mark.parametrize("pages", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("path", ["decode", "chunk"])
def test_attention_stablelm3b_shapes_hd80(gen, path, pages):
    """stablelm-3b's attention: hd 80 (2560 / 32 heads), G = 1. A page row
    is 5, 10 or 20 16-byte chunks (not a power of two); the decode path
    runs hd 80 on the hd-96 tiling with the last 16 dims dead, the chunk
    path 10 mma n tiles; chunk and decode lanes beside an idle one, a lane
    split over several spans."""
    if path == "decode":
        lanes = ((255, 1), (100, 1), (0, 0), (4095, 1))
    else:
        lanes = ((0, 128), (64, 100), (0, 0), (33, 1))
    _attn_check(lanes, n_kv=4, g=1, hd=80, quantized=pages == "int8",
                gen=gen, bf16=pages == "bf16")


@pytest.mark.parametrize("pages", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("path", ["decode", "chunk"])
def test_attention_gemma2_shapes_hd256_window_softcap(gen, path, pages):
    """gemma2-2b's attention: hd 256, G = 2, softcap 50, with and without
    a window (its local layers'; 100 keys here so that the window bites at
    these lengths). Over fp32 pages a ring stage holds 32 keys, not 64;
    the chunk path holds 32 mma n tiles a warp. Chunk and decode lanes
    beside an idle one."""
    if path == "decode":
        lanes = ((255, 1), (100, 1), (0, 0), (1030, 1))
    else:
        lanes = ((0, 128), (164, 100), (0, 0), (33, 1))
    for window in (100, None):
        _attn_check(lanes, n_kv=2, g=2, hd=256, quantized=pages == "int8",
                    gen=gen, bf16=pages == "bf16", window=window, cap=50.0)


def test_smem_bytes_mirror_the_librarys(gen):
    """``kernels.paged_attention.smem_bytes`` (which ``q_block_for`` and
    so the engine's stream account read on any device) equals the
    library's own count on every path, page kind, q dtype and span width
    (hd 256 over fp32 pages: 32-key stages; bf16 q over bf16 pages: the
    bf16-mma route's bf16 q rows, never more than fp32 q's)."""
    from repro_torch.kernels.paged_attention import smem_bytes
    lib = build.library()
    for hd in (32, 64, 80, 128, 256):
        for kind in (0, 1, 2):
            for q_blk, g in ((1, 1), (1, 2), (1, 5), (1, 8), (2, 6),
                             (8, 6), (16, 1), (16, 2), (16, 5), (16, 6),
                             (16, 8)):
                for sp in (4, 16, 64, 2048):
                    for q_bf16 in (0, 1):
                        want = lib.qmc_ragged_paged_attention_smem(
                            q_blk * g, q_blk, hd, kind, sp, q_bf16)
                        assert smem_bytes(q_blk * g, q_blk, hd, kind, sp,
                                          bool(q_bf16)) == want, (
                            hd, kind, q_blk, g, sp, q_bf16)
                    assert smem_bytes(q_blk * g, q_blk, hd, kind, sp,
                                      True) <= smem_bytes(
                        q_blk * g, q_blk, hd, kind, sp)


# ---------------------------------------------------------------------------
# the attention kernel over a page slice (a data rank's, on a mesh)
# ---------------------------------------------------------------------------
SLICE_LANES = ((0, 128), (64, 100), (0, 0), (33, 1), (255, 1), (1030, 1))


def _slice_case(gen, hd, pages, g=2):
    q, cache, qs, kl, n_new, _ = _attn_case(
        SLICE_LANES, n_kv=2, g=g, hd=hd, page=16,
        quantized=pages == "int8", gen=gen, bf16=pages == "bf16")
    return q, cache, qs, kl, n_new


def _local(cache, first, n):
    return {k: (v[first:first + n].contiguous() if k.endswith("_pages")
                else v) for k, v in cache.items()}


@pytest.mark.parametrize("slices", [2, 4])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("pages", ["fp32", "bf16", "int8"])
def test_sliced_attention_matches_sliced_plain(gen, pages, hd, slices):
    """The kernel over each of 2 or 4 page slices (the rows whose pages
    lie elsewhere contribute nothing) against the sliced plain version,
    chunk and decode lanes beside an idle one; the slices merged
    (``merge_slices``) against the kernel over the whole arena; a slice
    with no live page of a row gives o 0, m -1e30, l 0."""
    q, cache, qs, kl, n_new = _slice_case(gen, hd, pages)
    _sliced_check(q, cache, qs, kl, n_new, dict(n_kv=2, head_dim=hd),
                  slices)


@pytest.mark.parametrize("pages", ["fp32", "bf16", "int8"])
def test_whole_arena_slice_is_bit_identical(gen, pages):
    """The slice (0, n_pages) takes the sliced path (spans planned over the
    runs of entries in the slice: one run a lane here) and gives the call
    without a slice bit for bit."""
    for hd in (80, 128, 256):
        q, cache, qs, kl, _ = _slice_case(gen, hd, pages)
        kw = dict(n_kv=2, head_dim=hd)
        n = cache["k_pages"].shape[0]
        a = ragged_paged_attention_call(q, cache, qs, kl, **kw)
        b = ragged_paged_attention_call(q, cache, qs, kl,
                                        page_slice=(0, n), **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y), hd


def _moe_model(cf=1.25):
    """A MoE stack whose expert leaves the qmm kernels take (256 x 512
    and 512 x 256, E = 4, top-2), quantized for serving."""
    from repro_torch.core.serving_quant import quantize_for_serving
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import init_params
    cfg = ModelConfig(name="m", family="moe", n_layers=2, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=512, vocab=1024,
                      n_experts=4, topk=2, moe_pattern=(True,),
                      capacity_factor=cf)
    params = quantize_for_serving(init_params(cfg, 0, device="cuda"),
                                  QMCConfig(rho=0.3, granularity="subtile"),
                                  min_dim=64)
    return cfg, params


def test_moe_block_graph_replays_bit_identical_to_eager(gen):
    """The MoE block captured into one CUDA graph and replayed three
    times: each replay equals the eager call bit for bit (y and aux)."""
    from repro_torch.models.model import group_slice
    from repro_torch.models.moe import moe_block
    cfg, params = _moe_model()
    p = group_slice(params["blocks"]["b0"]["ffn"], 1)
    x = torch.randn((4, 16, cfg.d_model), generator=gen, device="cuda")
    y_e, aux_e = moe_block(p, x, cfg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe_block(p, x, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g, aux_g = moe_block(p, x, cfg)
    for _ in range(3):
        y_g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y_g, y_e) and torch.equal(aux_g, aux_e)


@pytest.mark.parametrize("rows", [4, 256])
def test_moe_expert_products_through_qmm_kernels(gen, rows):
    """Every expert product of a call through the qmm kernels (E x 3
    launches; at capacity factor 1.0, 4 rows give a capacity of 2, padded
    to the decode kernel's 8, and 256 rows one of 128, the column-strip
    kernel's), within 1e-4 * max|y| of the plain versions, and qmm's
    "ref" path never taken."""
    import dataclasses
    from repro_torch.models.model import group_slice
    from repro_torch.models.moe import capacity, moe_block
    cfg, params = _moe_model()
    cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    p = group_slice(params["blocks"]["b0"]["ffn"], 0)
    x = torch.randn((rows, 1, cfg.d_model), generator=gen, device="cuda")
    cap = capacity(rows, cfg)
    build.reset_launches()
    kops.reset_path_counts()
    y, aux = moe_block(p, x, cfg)
    torch.cuda.synchronize()
    path = kops.qmm_plan(cap, cfg.d_model, cfg.d_ff, (8, 128))["path"]
    assert path == ("decode" if rows == 4 else "colstrip")
    assert kops.path_counts[path] == 3 * cfg.n_experts
    assert kops.path_counts["ref"] == 0
    assert build.launches[f"qmm_{path}"] == 3 * cfg.n_experts
    y_p, aux_p = moe_block(p, x, cfg, use_kernels=False)
    torch.cuda.synchronize()
    assert float((y - y_p).abs().max()) <= 1e-4 * float(y_p.abs().max())
    torch.testing.assert_close(aux, aux_p, atol=1e-6, rtol=1e-6)


def test_moe_step_graphed_matches_eager_and_reads_nothing_back(gen):
    """A MoE stack's step set: one eager step under the sync debugger,
    then a prefill rung and two decode rounds graphed against eager
    (tokens identical, logprobs within 1e-5)."""
    import numpy as np
    cfg, params = _moe_model()
    rng = np.random.default_rng(1)
    rounds = [(rng.integers(2, 1024, (4, 16)), [0, 0, 0, 0],
               [16, 9, 16, 0]),
              (rng.integers(2, 1024, (4, 1)), [16, 9, 16, 0], [1, 1, 1, 0]),
              (rng.integers(2, 1024, (4, 1)), [17, 10, 17, 0],
               [1, 1, 0, 0])]
    runs = {}
    for graphs in (False, True):
        sset, arena = _step_set(cfg, graphs)
        if not graphs:
            z = np.zeros(4, np.int32)
            sset.step(params, np.zeros((4, 1), np.int32), arena, z, z,
                      samplib.lane_inputs(4))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                sset.step(params, np.ones((4, 1), np.int32), arena, z, z,
                          samplib.lane_inputs(4))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        outs = []
        for toks, start, n_new in rounds:
            tok, logp = sset.step(params, toks.astype(np.int32), arena,
                                  np.array(start, np.int32),
                                  np.array(n_new, np.int32),
                                  samplib.lane_inputs(4))
            outs.append((tok.clone(), logp.clone()))
        torch.cuda.synchronize()
        runs[graphs] = outs
    for (te, le), (tg, lg) in zip(runs[False], runs[True]):
        assert torch.equal(te, tg)
        torch.testing.assert_close(lg, le, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-2b"])
def test_contiguous_decode_step_kernels_match_plain(gen, arch):
    """Reduced whisper-medium (encoder frames, cross-attention) and
    internvl2-2b (a prefix of vision embeddings), QMC weights: prefill
    and one decode step through the qmm kernels against the plain
    versions, logits within 1e-3 * max|logits|."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.serving_quant import quantize_for_serving
    from repro_torch.models.model import decode_step, init_params, prefill
    cfg = reduced_config(arch)
    params = quantize_for_serving(init_params(cfg, 0, device="cuda"),
                                  QMCConfig(rho=0.3, granularity="subtile"),
                                  min_dim=64)
    b, s = 2, 9
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                         device="cuda")
    kw = {}
    if cfg.is_encdec:
        kw["frames"] = 0.1 * torch.randn((b, cfg.enc_seq, cfg.d_model),
                                         generator=gen, device="cuda")
    if cfg.n_vis_tokens:
        kw["vis_embeds"] = 0.1 * torch.randn(
            (b, cfg.n_vis_tokens, cfg.d_model), generator=gen, device="cuda")
    out = {}
    for use_kernels in (True, False):
        build.reset_launches()
        lg, cache = prefill(cfg, params, toks[:, :s], max_len=32,
                            cache_dtype=torch.float32,
                            use_kernels=use_kernels, **kw)
        lg2, _ = decode_step(cfg, params, toks[:, s:], cache,
                             s + cfg.n_vis_tokens, use_kernels=use_kernels)
        torch.cuda.synchronize()
        assert (build.launches["qmm_decode"] > 0) == use_kernels
        out[use_kernels] = (lg, lg2)
    for k, p in zip(out[True], out[False]):
        assert float((k - p).abs().max()) <= 1e-3 * float(p.abs().max())


# ---------------------------------------------------------------------------
# the serving mesh's MoE and hybrid ranks
# ---------------------------------------------------------------------------
class _RecordingMesh:
    """A (1, 2) mesh rank whose collectives only record their calls: what
    an EP rank computes before its one ``moe`` sum over ``model``."""

    axis_names = ("data", "model")

    def __init__(self, m):
        import numpy as np
        self.devices = np.empty((1, 2), dtype=object)
        self.groups = {"model": object()}
        self.m = m
        self.sums = []

    def index(self, axis):
        return self.m if axis == "model" else 0

    def all_reduce(self, t, axis, op="sum", kind="serve"):
        self.sums.append((axis, op, kind))
        return t


@pytest.mark.parametrize("rows", [4, 256])
def test_moe_ep_rank_runs_its_experts_through_qmm(gen, rows):
    """Each rank of a (1, 2) EP mesh holds 2 of the 4 experts (its ``[E]``
    lists ``None`` elsewhere, ``launch.sharding.shard_params``): its call
    runs 2 x 3 products through the qmm kernels (decode-width at 4 rows,
    column-strip at 256), never qmm's "ref" path, and makes one ``moe``
    sum; the two ranks' partial outputs add up to the whole block's
    within 1e-4 * max|y|."""
    import dataclasses
    from repro_torch import runtime_context as ctx
    from repro_torch.launch import sharding as shd
    from repro_torch.models.model import group_slice
    from repro_torch.models.moe import moe_block
    cfg, params = _moe_model()
    cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    x = torch.randn((rows, 1, cfg.d_model), generator=gen, device="cuda")
    whole, _ = moe_block(group_slice(params["blocks"]["b0"]["ffn"], 0), x,
                         cfg)
    total = torch.zeros_like(whole)
    path = "decode" if rows == 4 else "colstrip"
    for m in range(2):
        mesh = _RecordingMesh(m)
        p = group_slice(shd.shard_params(params, mesh)["blocks"]["b0"][
            "ffn"], 0)
        assert [i for i, q in enumerate(p["w_up"]) if q is not None] \
            == [2 * m, 2 * m + 1]
        build.reset_launches()
        kops.reset_path_counts()
        with ctx.use_mesh(mesh):
            y, _ = moe_block(p, x, cfg)
        torch.cuda.synchronize()
        assert build.launches[f"qmm_{path}"] == 2 * 3
        assert kops.path_counts["ref"] == 0
        assert mesh.sums == [("model", "sum", "moe")]
        total += y
    assert float((total - whole).abs().max()) <= \
        1e-4 * float(whole.abs().max())


@pytest.mark.parametrize("pages", ["fp32", "bf16", "int8"])
def test_sliced_attention_at_hymba_shapes(gen, pages):
    """The kernel over each of 2 page slices at hymba-1.5b's shapes (5 KV
    heads of 25, G = 5, hd 64, its 1024-token window, kv_len up to 2048;
    chip_smoke's row 3d-h), decode lanes and a chunk past the window,
    against the sliced plain version; the slices merged against the
    whole-arena call."""
    lanes = ((2047, 1), (1800, 1), (1100, 128), (0, 0), (1030, 1))
    q, cache, qs, kl, n_new, _ = _attn_case(
        lanes, n_kv=5, g=5, hd=64, page=16, quantized=pages == "int8",
        gen=gen, bf16=pages == "bf16")
    _from_chip_smoke("in_order")(cache)
    _sliced_check(q, cache, qs, kl, n_new,
                  dict(n_kv=5, head_dim=64, window=1024))


# ---------------------------------------------------------------------------
# the training mesh's collectives with gradients, on CUDA tensors
# ---------------------------------------------------------------------------
def _family_grads_rank(mesh, cfg, params, batch, microbatches):
    """One gloo rank on the card: step 0's loss, aux and gradients of the
    sharded step on its slices and rows (made whole), and its collectives
    by kind."""
    from repro_torch import tree as T
    from repro_torch.launch import sharding as shd
    from repro_torch.train.step import mesh_grads_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    whole = T.map_(lambda t: t.cuda(), params)
    specs = shd.train_specs(whole, mesh)
    local = shd.train_slices(whole, mesh, specs)
    rows = shd.batch_rows(mesh, batch["tokens"].shape[0], microbatches)
    batch = {k: v[rows].cuda() for k, v in batch.items()}
    loss, metrics, grads = mesh_grads_fn(cfg, mesh, microbatches)(local,
                                                                  batch)
    kinds = {k: v[0] for k, v in mesh.by_kind.items()}
    grads = T.map_(lambda g: g.cpu(), shd.unshard(grads, mesh, specs))
    return float(loss), float(metrics["aux"]), grads, kinds


@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-370m"])
def test_training_mesh_collectives_on_the_card(gen, arch):
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.model import init_params
    from repro_torch.train.step import grads_fn
    cfg = dataclasses.replace(reduced_config(arch), capacity_factor=1.25)
    params = init_params(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (8, 17), generator=torch.Generator(
        ).manual_seed(3))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    one = grads_fn(cfg, 2)(T.map_(lambda t: t.cuda(), params),
                           {k: v.cuda() for k, v in batch.items()})
    runs = spawn(_family_grads_rank, (2, 2), backend="gloo",
                 args=(cfg, params, batch, 2), timeout_s=300.0)
    want = dict(T.items(one[2]))
    for loss, aux, grads, kinds in runs:
        assert abs(loss - float(one[0])) <= 1e-5 * abs(float(one[0]))
        assert abs(aux - float(one[1]["aux"])) <= 1e-5 * abs(
            float(one[1]["aux"]))
        for path, g in T.items(grads):
            w = want[path].cpu()
            torch.testing.assert_close(g, w, rtol=1e-4,
                                       atol=2e-6 * float(w.abs().max()),
                                       msg=path)
        new = {"moe", "moe_dp"} if arch == "dbrx-132b" else {"gather",
                                                            "split"}
        assert new <= set(kinds), kinds

