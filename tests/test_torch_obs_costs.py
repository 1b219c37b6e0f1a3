"""The port's cost attribution (``repro_torch.obs.costs``) on the CPU:

  * capture is off by default and costs nothing; on, every step-set call
    lands in its width's row, and a row with no count (the page ops)
    suppresses its drift instead of reporting 0;
  * ``FnCost``'s roofline by hand with the H100 SXM5 figures (3.35 TB/s,
    495 TFLOP/s TF32: two products per k step for an fp32 activation,
    one for bf16);
  * the per-width count (``step_work``) by hand on a QMC model whose
    projections are part QTensor (M padded to 8) and part dense, on an
    attention stack and on a hybrid one (the Mamba2 mixer's projections,
    state traffic and scan);
  * the count's FLOPs against the JAX step's XLA ``cost_analysis()`` for
    the same weights at C = 1 and C = chunk: at one layer group the port
    counts 0.85-1.0 of XLA's (measured 0.888-0.897: the count leaves out
    the norms, rotary, softmax exponentials and the sampling head, ~10% at
    this 64-wide config); at two groups XLA counts the scanned group's
    body once (its ``while`` loop), so XLA's FLOPs stay within 1% of the
    one-group figure while the port's add one group's count exactly;
  * the modeled memory-system cost by hand (``tests/test_obs_costs.py``
    on the port's ``memsys``), ``detect_weights_method`` on the port's
    trees;
  * an engine run under capture: one attributed ``step``/``solo_step``
    dispatch per round (synchronous, pipelined, speculative, prefix
    cache), the ``serve_cost_*`` metrics, the ``cost/<fn>`` counter
    tracks on the process tracer, and nothing of it with capture off.
"""
import numpy as np
import pytest
import torch

import jax

from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import init_params as jax_init_params
from repro.obs import costs as jax_costs
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import QTensor
from repro_torch.core.serving_quant import quantize_for_serving
from repro_torch.launch import roofline as rl
from repro_torch.memsys.workload import make_traffic
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import paged_init_cache
from repro_torch.models.model import init_params
from repro_torch.obs import costs as obs_costs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import EngineStats, Request, ServeEngine
from test_torch_bridge import jax_tree_to_numpy

PAGE = 16


@pytest.fixture
def capture():
    prev = obs_costs.enable_capture()
    yield
    obs_costs.enable_capture(prev)


@pytest.fixture(scope="module")
def port(serve_cfg, serve_params):
    from conftest import SERVE_BASE
    cfg = ModelConfig(name="t", family="dense", **SERVE_BASE)
    return cfg, params_from_numpy(jax_tree_to_numpy(serve_params),
                                  device="cpu")


def _reqs(cls=Request, n=3, lo=8, hi=20, seed=0, max_new=4):
    rng = np.random.default_rng(seed)
    return [cls(uid=i,
                prompt=rng.integers(2, 64, size=int(L)).astype(np.int32),
                max_new_tokens=max_new)
            for i, L in enumerate(rng.integers(lo, hi, size=n))]


def _engine(port, **kw):
    cfg, params = port
    kw.setdefault("metrics", obs_metrics.Registry())
    return ServeEngine(cfg, params, slots=2, max_len=64, page_size=PAGE,
                       device="cpu", **kw)


# ==========================================================================
# capture mechanics
# ==========================================================================
def test_capture_off_by_default_costs_nothing(port):
    eng = _engine(port)
    eng.run(_reqs())
    sset = eng.step_set
    for fn in (sset.step, sset.solo_step, sset.apply_page_ops):
        assert fn.cost_by_key == {} and fn.calls_by_key == {}
    assert sset.step.calls + sset.solo_step.calls == eng.stats.rounds
    assert eng.last_cost_report is None


def test_collect_diffs_against_baseline(port, capture):
    eng = _engine(port)
    eng.run(_reqs())
    base = obs_costs.snapshot(eng.step_set)
    eng.run(_reqs())
    rows = obs_costs.collect(eng.step_set, base)
    steps = [r for r in rows if r.fn in ("step", "solo_step")]
    assert sum(r.calls for r in steps) == eng.stats.rounds   # this run
    assert obs_costs.collect(eng.step_set,
                             obs_costs.snapshot(eng.step_set)) == []


def test_rows_without_a_count_suppress_drift(port, capture):
    eng = _engine(port)
    eng.run(_reqs())
    rows = {r.label: r for r in eng.last_cost_report.fns}
    ops = rows["apply_page_ops/call"]
    assert ops.calls == eng.stats.page_op_flushes > 0
    assert not ops.captured and ops.drift == 0.0
    snap = eng._metrics.snapshot()
    drift_fns = {s["labels"]["fn"]
                 for s in snap["serve_cost_drift_ratio"]["series"]}
    assert "apply_page_ops/call" not in drift_fns
    assert {r.label for r in rows.values() if r.captured} == drift_fns


def test_flush_suppresses_drift_for_uncounted_rows():
    reg = obs_metrics.Registry()
    rows = [obs_costs.FnCost(fn="step", key="C1", calls=4, wall_s=1.0,
                             flops_per_call=1e9, bytes_per_call=1e6),
            obs_costs.FnCost(fn="apply_page_ops", key="call", calls=2,
                             wall_s=0.1, flops_per_call=0.0,
                             bytes_per_call=0.0)]
    report = obs_costs.CostReport(fns=rows, modeled={"degenerate": True},
                                  measured_wall_s=1.1,
                                  measured_device_s=1.0, tokens_out=8)
    obs_costs.flush_metrics(reg, report)
    snap = reg.snapshot()
    assert snap["serve_cost_flops_total"]["series"] == [
        {"labels": {"fn": "apply_page_ops/call"}, "value": 0.0},
        {"labels": {"fn": "step/C1"}, "value": 4e9}]
    drift = snap["serve_cost_drift_ratio"]["series"]
    assert [s["labels"]["fn"] for s in drift] == ["step/C1"]
    assert "serve_cost_modeled_bytes_per_token" not in snap


# ==========================================================================
# the roofline by hand, H100 SXM5 figures
# ==========================================================================
@pytest.mark.parametrize("dtype,products", [("float32", 2),
                                            ("bfloat16", 1)])
def test_fncost_roofline_by_hand(dtype, products):
    assert (rl.HBM_BW, rl.TF32_FLOPS) == (3.35e12, 495e12)
    # FLOPs that take exactly 1 s at the TF32 peak with this dtype's
    # products, bytes that take 0.5 s at 3.35 TB/s: the bound is 1 s
    r = obs_costs.FnCost(fn="step", key="C1", calls=2, wall_s=6.0,
                         flops_per_call=495e12 / products,
                         bytes_per_call=3.35e12 * 0.5, act_dtype=dtype)
    assert r.roofline().t_compute == pytest.approx(1.0)
    assert r.roofline().t_memory == pytest.approx(0.5)
    assert r.roofline().t_collective == 0.0
    assert r.roofline().bottleneck == "compute"
    assert r.roofline_s == pytest.approx(2.0)          # 2 calls x 1 s
    assert r.drift == pytest.approx(3.0)               # 6 s / 2 s
    assert r.roofline_fraction == pytest.approx(1 / 3)
    assert r.arithmetic_intensity == pytest.approx(
        (495e12 / products) / (3.35e12 * 0.5))
    d = r.to_dict()
    assert d["drift"] == pytest.approx(3.0) and d["act_dtype"] == dtype


def test_peaks_by_card_name():
    assert rl.peaks("NVIDIA H100 80GB HBM3")[:4] == (
        3.35e12, 67e12, 495e12, "H100")
    assert rl.peaks("NVIDIA H100 PCIe")[3] == "H100 PCIe"
    assert rl.peaks("NVIDIA H100 NVL")[2] == 417.5e12
    assert rl.peaks("some other card")[4] is False


# ==========================================================================
# the per-width count by hand
# ==========================================================================
HAND = dict(n_layers=1, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
            vocab=128)


@pytest.mark.parametrize("lanes,c", [(4, 1), (1, 16), (4, 32)])
def test_step_work_by_hand(lanes, c):
    cfg = ModelConfig(name="h", family="dense", **HAND)
    q = quantize_for_serving(init_params(cfg, 0, device="cpu"),
                             QMCConfig(rho=0.3, granularity="subtile"),
                             min_dim=64)
    blk = q["blocks"]["b0"]
    assert isinstance(blk["attn"]["wq"][0], QTensor)      # 128 x 128
    assert isinstance(blk["attn"]["wk"], torch.Tensor)    # 128 x 64
    arena = paged_init_cache(cfg, 9, PAGE, lanes, 4, dtype=torch.float32,
                             device="cpu")
    m = lanes * c
    m8 = -(-m // 8) * 8
    flops = nbytes = 0
    for k, n, quant in [(128, 128, True), (128, 64, False),
                        (128, 64, False), (128, 128, True),
                        (128, 256, True), (128, 256, True),
                        (256, 128, True), (128, 128, True)]:
        if quant:       # codes, stream positions + tags, scales, x, y
            flops += 2 * m8 * k * n
            nbytes += (k * n + (k // 8) * (n // 128) * (4 + 1) + 2 * n * 4
                       + 4 * m8 * k + 4 * m8 * n)
        else:
            flops += 2 * m * k * n
            nbytes += 4 * k * n + 4 * m * k + 4 * m * n
    # attention over the full [lanes, 4] table: q read, o (fp32) + m, l
    # written, K and V of every page, the table, q_start and kv_len
    hd, heads, keys = 32, 4, lanes * c * 4 * PAGE
    flops += 4 * hd * heads * keys
    nbytes += (m * heads * hd * (4 + 4) + 2 * m * heads * 4
               + 2 * lanes * 4 * PAGE * 2 * hd * 4 + lanes * 4 * 4
               + 2 * lanes * 4)
    w = obs_costs.step_work(cfg, q, arena, lanes=lanes, c=c)
    assert w == {"flops": flops, "bytes": nbytes, "dtype": "float32"}


@pytest.mark.parametrize("lanes,c", [(4, 1), (1, 16), (4, 32), (2, 300)])
def test_step_work_by_hand_hybrid(lanes, c):
    """A hybrid block (parallel attention and Mamba2 mixer): the mixer's
    projections at M (``out_proj`` a QTensor, ``in_proj`` 128 x 552 dense:
    552 does not tile by 128), its state read and written per lane, and
    the scan: the recurrence at C = 1 (5 FLOPs per state element), the
    chunked scan at the width's chunk above (C = 300: two 256 chunks)."""
    cfg = ModelConfig(name="h", family="hybrid", pattern=("hybrid",),
                      d_state=16, ssm_headdim=32, **HAND)
    q = quantize_for_serving(init_params(cfg, 0, device="cpu"),
                             QMCConfig(rho=0.3, granularity="subtile"),
                             min_dim=64)
    mix = q["blocks"]["b0"]["mamba"]
    assert isinstance(mix["out_proj"][0], QTensor)       # 256 x 128
    assert isinstance(mix["in_proj"], torch.Tensor)      # 128 x 552
    arena = paged_init_cache(cfg, 9, PAGE, lanes, 4, dtype=torch.float32,
                             device="cpu")
    m = lanes * c
    m8 = -(-m // 8) * 8
    flops = nbytes = 0
    for k, n, quant in [(128, 128, True), (128, 64, False),
                        (128, 64, False), (128, 128, True),
                        (128, 552, False), (256, 128, True),
                        (128, 256, True), (128, 256, True),
                        (256, 128, True), (128, 128, True)]:
        if quant:
            flops += 2 * m8 * k * n
            nbytes += (k * n + (k // 8) * (n // 128) * (4 + 1) + 2 * n * 4
                       + 4 * m8 * k + 4 * m8 * n)
        else:
            flops += 2 * m * k * n
            nbytes += 4 * k * n + 4 * m * k + 4 * m * n
    hd, heads, keys = 32, 4, lanes * c * 4 * PAGE
    flops += 4 * hd * heads * keys
    nbytes += (m * heads * hd * (4 + 4) + 2 * m * heads * 4
               + 2 * lanes * 4 * PAGE * 2 * hd * 4 + lanes * 4 * 4
               + 2 * lanes * 4)
    # the mixer: 8 heads of 32 x 16 fp32 state, 3 conv rows of 256 + 2 * 16
    state, conv = 8 * 32 * 16, 3 * 288
    nbytes += lanes * (2 * state * 4 + 2 * conv * 4)
    if c == 1:
        flops += 5 * lanes * state
    else:
        chunk = 256 if c >= 256 else 1 << (c - 1).bit_length()
        per_chunk = 2 * 8 * chunk * (chunk * (16 + 32) + 2 * 16 * 32)
        flops += lanes * -(-c // chunk) * per_chunk
    w = obs_costs.step_work(cfg, q, arena, lanes=lanes, c=c)
    assert w == {"flops": flops, "bytes": nbytes, "dtype": "float32"}


def _xla_and_port(n_layers):
    from conftest import SERVE_BASE
    base = dict(SERVE_BASE, n_layers=n_layers)
    jcfg = JaxModelConfig(name="t", family="dense", **base)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    pcfg = ModelConfig(name="t", family="dense", **base)
    pp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    kw = dict(slots=2, max_len=32, page_size=8)
    prev = (jax_costs.enable_capture(), obs_costs.enable_capture())
    try:
        jeng = JaxEngine(jcfg, jp, weight_plan=False, **kw)
        jeng.run(_reqs(JaxRequest))
        peng = ServeEngine(pcfg, pp, device="cpu",
                           metrics=obs_metrics.Registry(), **kw)
        peng.run(_reqs())
    finally:
        jax_costs.enable_capture(prev[0])
        obs_costs.enable_capture(prev[1])
    rows = [{r.label: r.flops_per_call for r in e.last_cost_report.fns}
            for e in (peng, jeng)]
    return rows, peng.chunk


@pytest.fixture(scope="module")
def flops_by_groups():
    return {n: _xla_and_port(n) for n in (1, 2)}


@pytest.mark.parametrize("width", ["C1", "chunk"])
def test_step_flops_against_xla(flops_by_groups, width):
    (one_port, one_xla), chunk = flops_by_groups[1]
    (two_port, two_xla), _ = flops_by_groups[2]
    label = f"step/C{chunk}" if width == "chunk" else "step/C1"
    ratio = one_port[label] / one_xla[label]
    assert 0.85 <= ratio <= 1.0, ratio
    # two groups: XLA counts the scanned body once, the port each group
    assert two_xla[label] == pytest.approx(one_xla[label], rel=0.01)
    assert two_port[label] > 1.8 * one_port[label]
    assert 1.6 <= two_port[label] / two_xla[label] <= 2.0


# ==========================================================================
# modeled memsys cost: hand-pinned formula + qmc < fp32 (the port's memsys)
# ==========================================================================
def _fake_stats():
    s = EngineStats()
    s.rounds = 10
    s.tokens_out = 20
    s.prefill_chunks = 4
    s.kv_pages_live = 30
    s.prefill_kv_pages_live = 12
    s.prefill_kv_pages_written = 6
    return s


def test_modeled_bytes_per_token_by_hand(port):
    cfg = port[0]
    bits = 32
    m = obs_costs.modeled_memsys(cfg, _fake_stats(), method="fp32",
                                 page=PAGE, kv_dtype_bits=bits)
    kv_dim = cfg.n_kv_heads * (cfg.d_model // cfg.n_heads)
    per_page = 2 * cfg.n_layers * kv_dim * PAGE * bits
    assert per_page == 2 * 2 * 32 * 16 * 32
    lane_steps = 20 + 4
    kv_read = (30 + 12) * per_page
    kv_write = 6 * per_page + 20 * per_page / PAGE
    kv_per_round = (kv_read + kv_write) / 10
    act_per_round = 4 * cfg.n_layers * cfg.d_model * 16 * lane_steps / 10
    w_per_round = cfg.active_param_count() * 32.0
    expect = (w_per_round + kv_per_round + act_per_round) * 10 / 8 / 20
    assert m["kv_bits_per_round"] == pytest.approx(kv_per_round)
    assert m["act_bits_per_round"] == pytest.approx(act_per_round)
    assert m["weight_bits_per_round"] == pytest.approx(w_per_round)
    assert m["bytes_per_token"] == pytest.approx(expect)
    assert not m["degenerate"]
    assert m["hetero"]["energy_j"] > 0
    assert m["conventional"]["latency_s"] > 0


def test_modeled_qmc_strictly_below_fp32(port):
    stats = _fake_stats()
    fp32 = obs_costs.modeled_memsys(port[0], stats, method="fp32",
                                    page=PAGE)
    qmc = obs_costs.modeled_memsys(port[0], stats, method="qmc", page=PAGE)
    assert qmc["bytes_per_token"] < fp32["bytes_per_token"]
    assert qmc["kv_bits_per_round"] == fp32["kv_bits_per_round"]
    assert qmc["weight_bits_per_round"] < fp32["weight_bits_per_round"]


def test_modeled_degenerate_run(port):
    m = obs_costs.modeled_memsys(port[0], EngineStats(), method="fp16",
                                 page=PAGE)
    assert m["degenerate"] and m["bytes_per_token"] == 0.0
    t32, t16 = make_traffic(port[0], "fp32"), make_traffic(port[0], "fp16")
    assert t32.weight_bits == pytest.approx(2 * t16.weight_bits)


def test_detect_weights_method(port):
    cfg, params = port
    assert obs_costs.detect_weights_method(params) == "fp32"
    q = quantize_for_serving(params, QMCConfig(rho=0.3,
                                               granularity="subtile"),
                             min_dim=64)
    assert obs_costs.detect_weights_method(q) == "qmc"
    half = {"w": torch.zeros(2, 2, dtype=torch.bfloat16)}
    assert obs_costs.detect_weights_method(half) == "fp16"


# ==========================================================================
# end to end through the engine
# ==========================================================================
@pytest.mark.parametrize("kind", ["sync", "pipelined", "speculative",
                                  "prefix_cache"])
def test_engine_run_attributes_one_dispatch_per_round(port, capture, kind):
    kw = {"sync": {}, "pipelined": dict(pipelined=True),
          "speculative": dict(speculative_k=4),
          "prefix_cache": dict(prefix_cache=True)}[kind]
    reg = obs_metrics.Registry()
    trc = obs_trace.Tracer()
    eng = _engine(port, metrics=reg, tracer=trc, **kw)
    reqs = _reqs(n=5, max_new=8)
    if kind == "prefix_cache":
        for r in reqs[1:]:
            r.prompt = np.concatenate([reqs[0].prompt[:PAGE], r.prompt])
    eng.run(reqs)
    rep = eng.last_cost_report
    rows = [r for r in rep.fns if r.fn in ("step", "solo_step")]
    assert rows and all(r.key.startswith("C") and r.captured for r in rows)
    assert sum(r.calls for r in rows) == eng.stats.rounds
    assert rep.tokens_out == eng.stats.tokens_out
    assert rep.measured_wall_s > 0 and rep.measured_device_s > 0
    assert rep.modeled["method"] == "fp32" and not rep.modeled["degenerate"]
    assert "step/C1" in rep.table()
    snap = reg.snapshot()
    assert "serve_cost_modeled_bytes_per_token" in snap
    flops = {s["labels"]["fn"]: s["value"]
             for s in snap["serve_cost_flops_total"]["series"]}
    for r in rows:
        assert flops[r.label] == r.flops_per_call * r.calls
    counters = [e for e in trc.events if e["ph"] == "C"]
    pool = [e for e in counters if e["name"] == "pool/pages"]
    assert len(pool) == eng.stats.rounds
    if kind == "pipelined":
        assert eng.stats.pipelined_rounds > 0
    if kind == "speculative":
        assert eng.stats.spec_rounds > 0


def test_cost_counter_track_via_default_tracer(port, capture):
    """The cumulative ``cost/<fn>`` tracks go to the PROCESS tracer (where
    the step set's compile events go), one sample per step call."""
    trc = obs_trace.Tracer()
    prev = obs_trace.set_tracer(trc)
    try:
        eng = _engine(port)
        eng.run(_reqs())
    finally:
        obs_trace.set_tracer(prev)
    tracks = [e for e in trc.events if e["ph"] == "C"
              and e["name"] in ("cost/step", "cost/solo_step")]
    assert len(tracks) == eng.stats.rounds
    for name in ("cost/step", "cost/solo_step"):
        cum = [e["args"]["bytes"] for e in tracks if e["name"] == name]
        assert cum == sorted(cum)
    assert not [e for e in trc.events
                if e["name"] == "cost/apply_page_ops"]   # no count, no track
