"""The port's observability (``repro_torch.obs``) on the CPU, at
``tests/conftest.py:SERVE_BASE`` width:

  * the copied metrics registry and span tracer, case for case from
    ``tests/test_obs.py``, and their process defaults kept apart from the
    JAX package's;
  * trace parity: for one run, the port's and the JAX engine's event
    streams (name, ph and args; timestamps, ``jit/*`` instants,
    ``cost/*`` tracks and the port-only ``step/*`` and ``device/*``
    spans dropped) are equal on greedy, sampled, prefix-cache
    with dedup, speculative (k = 4), pipelined and preempting engines, and
    so are the registry totals (the ``serve_jit_*`` series apart; the
    phase histogram by count) and the ``phase_seconds`` keys;
  * token conservation and one ``req/first_token`` per emitting request;
  * the step call's ``step/*`` spans inside their round phase, one
    ``step/launch`` a round whose rows add up to ``EngineStats.
    step_rows`` / ``step_live_rows``, the device fields None on the CPU
    and with tracing off, and ``obs.trace.idle_by_span`` on synthetic
    intervals;
  * the step set's compile events (``jit/compile`` per new width,
    ``jit/unexpected_retrace`` past the surface);
  * the serving CLI's ``--trace-out``, ``--metrics-out``, ``--cost-report``
    and ``--profile`` on ``--device cpu``.
"""
import json

import numpy as np
import pytest

from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models.config import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import Registry, log_buckets
from repro_torch.obs.trace import Tracer
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams
from test_torch_bridge import jax_tree_to_numpy

PAGE = 8


# ==========================================================================
# metrics mechanics (tests/test_obs.py, on the port's copy)
# ==========================================================================
def test_counter_inc_value_and_labels():
    reg = Registry()
    c = reg.counter("hits_total", "hits", labels=("kind",))
    c.inc(kind="a")
    c.inc(2, kind="a")
    c.inc(5, kind="b")
    assert c.value(kind="a") == 3
    assert c.value(kind="b") == 5
    assert c.value(kind="never") == 0
    with pytest.raises(ValueError):
        c.inc(-1, kind="a")            # counters only go up
    with pytest.raises(ValueError):
        c.inc(wrong="a")               # undeclared label name


def test_gauge_set_add():
    g = Registry().gauge("pages")
    g.set(4)
    g.add(-1)
    assert g.value() == 3


def test_histogram_buckets_and_sum():
    h = Registry().histogram("lat", buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.005, 0.005, 5.0):
        h.observe(v)
    assert h.count() == 4
    assert h.sum() == pytest.approx(5.0105)
    row = h._series[()]
    assert row[0] == [1, 2, 0, 1]      # last slot = implicit +Inf bucket
    with pytest.raises(ValueError):
        Registry().histogram("bad", buckets=(1.0, 1.0, 2.0))


def test_log_buckets_span():
    b = log_buckets()
    assert b[0] == pytest.approx(1e-6)
    assert b[-1] > 1.0                 # reaches into capture seconds
    assert all(x < y for x, y in zip(b, b[1:]))


@pytest.mark.parametrize("drift", ["labels", "type", "buckets"])
def test_registry_get_or_create_and_mismatch(drift):
    reg = Registry()
    c1 = reg.counter("x_total", labels=("k",))
    assert reg.counter("x_total", labels=("k",)) is c1
    h = reg.histogram("h", buckets=(1.0, 2.0))
    assert reg.histogram("h", buckets=(1.0, 2.0)) is h
    with pytest.raises(ValueError):
        if drift == "labels":
            reg.counter("x_total", labels=("other",))
        elif drift == "type":
            reg.gauge("x_total")
        else:
            reg.histogram("h", buckets=(1.0, 3.0))


def test_prometheus_exposition():
    reg = Registry()
    reg.counter("req_total", "requests", labels=("kind",)).inc(3, kind="a")
    reg.gauge("pages").set(7)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 0.1))
    h.observe(0.005)
    h.observe(0.05)
    h.observe(9.0)
    text = reg.to_prometheus()
    assert '# TYPE req_total counter' in text
    assert 'req_total{kind="a"} 3' in text
    assert 'pages 7' in text
    assert 'lat_seconds_bucket{le="0.01"} 1' in text
    assert 'lat_seconds_bucket{le="0.1"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 3' in text
    assert 'lat_seconds_count 3' in text


def test_snapshot_json_roundtrip(tmp_path):
    reg = Registry()
    reg.counter("a_total", labels=("k",)).inc(2, k="x")
    reg.histogram("h", buckets=(1.0,)).observe(0.5)
    path = tmp_path / "m.json"
    reg.write_json(str(path))
    snap = json.loads(path.read_text())
    assert snap["a_total"]["series"] == [
        {"labels": {"k": "x"}, "value": 2}]
    assert snap["h"]["type"] == "histogram"
    assert snap["h"]["series"][0]["count"] == 1


# ==========================================================================
# tracer mechanics
# ==========================================================================
def test_disabled_tracer_is_noop():
    t = Tracer(enabled=False)
    s1 = t.span("a")
    s2 = t.span("b", x=1)
    assert s1 is s2                    # shared null span, no allocation
    with s1:
        t.instant("i", u=1)
        t.counter("c", v=2)
        t.complete("x", 0.0, 1.0)
    assert t.events == []


def test_chrome_trace_schema(tmp_path):
    t = Tracer()
    with t.span("outer", tag="o"):
        with t.span("inner"):
            pass
        t.instant("point", uid=3)
    t.counter("pages", used=4)
    for ev in t.events:
        assert {"name", "ph", "ts", "pid"} <= set(ev)
        if ev["ph"] == "X":
            assert ev["dur"] >= 0 and "tid" in ev
        if ev["ph"] == "i":
            assert ev["s"] == "t" and "tid" in ev
    path = tmp_path / "t.json"
    n = t.export(str(path))
    doc = json.loads(path.read_text())
    assert len(doc["traceEvents"]) == n == 4
    assert doc["displayTimeUnit"] == "ms"


def test_span_nesting_and_phase_totals():
    t = Tracer()
    with t.span("outer"):
        with t.span("inner"):
            pass
    inner = next(e for e in t.events if e["name"] == "inner")
    outer = next(e for e in t.events if e["name"] == "outer")
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    totals = t.phase_totals()
    assert totals["inner"] <= totals["outer"]


# (host spans, device spans, window, charges): nested phases where the
# innermost wins; overlapping device spans; gaps crossing several spans and
# uncovered pieces; spans and device work clipped to the window, and two
# spans begun together (the one that ends first is the inner)
IDLE_CASES = {
    "nested": ([(0, 100, "round"), (40, 90, "round/device_step"),
                (50, 60, "step/launch"), (60, 90, "step/wait")],
               [(52, 80)], (0, 100),
               {"round": 50, "round/device_step": 10, "step/launch": 2,
                "step/wait": 10}),
    "overlapping_device": ([], [(10, 30), (20, 40), (35, 50)], (0, 60),
                           {obs_trace.OUTSIDE: 20}),
    "crossing": ([(5, 15, "a"), (15, 25, "b"), (30, 35, "c")],
                 [(0, 2), (40, 45)], (0, 50),
                 {obs_trace.OUTSIDE: 18, "a": 10, "b": 10, "c": 5}),
    "clipped": ([(-10, 20, "outer"), (5, 20, "inner"), (5, 8, "first"),
                 (90, 130, "late")],
                [(-5, 2), (10, 12), (95, 140), (150, 160)], (0, 100),
                {"outer": 3, "first": 3, "inner": 10, "late": 5,
                 obs_trace.OUTSIDE: 70}),
}


@pytest.mark.parametrize("case", list(IDLE_CASES))
def test_idle_by_span(case):
    host, device, (t0, t1), want = IDLE_CASES[case]
    got = obs_trace.idle_by_span(host, device, t0, t1)
    assert got == pytest.approx(want)
    busy = sum(b - a for a, b in obs_trace.union(device, t0, t1))
    assert sum(got.values()) == pytest.approx(t1 - t0 - busy)


def test_device_clock_records_nothing_on_the_cpu():
    """An enabled tracer without an anchored run (always on the CPU) hands
    out the shared no-op device span and resolves to nothing."""
    t = Tracer()
    t.device_anchor()
    assert t.device_span("device/x") is t.device_span("device/y", a=1)
    with t.device_span("device/x"):
        pass
    assert t.resolve_device() == [] and t.events == []


def test_default_tracer_swap():
    assert not obs_trace.get_tracer().enabled   # process default is off
    mine = Tracer()
    prev = obs_trace.set_tracer(mine)
    try:
        assert obs_trace.active(None) is mine
        other = Tracer(enabled=False)
        assert obs_trace.active(other) is other
    finally:
        obs_trace.set_tracer(prev)


@pytest.mark.parametrize("kind", ["tracer", "registry"])
def test_process_defaults_are_the_ports_own(kind):
    """The two packages keep separate process defaults: installing one
    package's never reaches the other's call sites."""
    get, put, get_jax, cls = (
        (obs_trace.get_tracer, obs_trace.set_tracer, jax_trace.get_tracer,
         Tracer) if kind == "tracer" else
        (obs_metrics.get_registry, obs_metrics.set_registry,
         jax_metrics.get_registry, Registry))
    assert get() is not get_jax()
    mine = cls()
    prev = put(mine)
    try:
        assert get() is mine and get_jax() is not mine
    finally:
        put(prev)


# ==========================================================================
# engine parity with the JAX engine
# ==========================================================================
@pytest.fixture(scope="module")
def weights(serve_cfg, serve_params):
    from conftest import SERVE_BASE
    cfg = ModelConfig(name="t", family="dense", **SERVE_BASE)
    return (serve_cfg, serve_params), (cfg, params_from_numpy(
        jax_tree_to_numpy(serve_params), device="cpu"))


def _prompt(rng, n):
    return rng.integers(2, 64, int(n)).astype(np.int32)


def _plain(cls, n=6, seed=3, max_new=6, lo=4, hi=20, sampling=None,
           uid0=0):
    rng = np.random.default_rng(seed)
    return [cls(uid=uid0 + i, prompt=_prompt(rng, L), max_new_tokens=max_new,
                sampling=sampling)
            for i, L in enumerate(rng.integers(lo, hi, size=n))]


def _sampled(cls):
    sp = (SamplingParams if cls is Request else JaxSamplingParams)(
        temperature=0.8, top_k=8, top_p=0.9, seed=11)
    return _plain(cls, sampling=sp)


def _cached(cls):
    """Tenants of one page-aligned system prompt, and identical prompts
    admitted together (in-flight dedup, COW of the shared last page)."""
    rng = np.random.default_rng(5)
    sys_prompt = _prompt(rng, 2 * PAGE)
    reqs = [cls(uid=i, prompt=np.concatenate(
        [sys_prompt, _prompt(rng, 4)]).astype(np.int32), max_new_tokens=3)
        for i in range(4)]
    return reqs + [cls(uid=4 + i, prompt=sys_prompt.copy(),
                       max_new_tokens=3) for i in range(3)]


def _identical(cls):
    """One three-page prompt four times: the copies behind the first wait
    for its chunked prefill, then alias its pages (in-flight dedup)."""
    prompt = _prompt(np.random.default_rng(7), 3 * PAGE)
    return [cls(uid=i, prompt=prompt.copy(), max_new_tokens=4)
            for i in range(4)]


def _repetitive(cls):
    rng = np.random.default_rng(29)
    return [cls(uid=i, prompt=np.tile(rng.integers(2, 64, 4), 4).astype(
        np.int32), max_new_tokens=12) for i in range(3)]


# scenario -> (engine kwargs, requests)
SCENARIOS = {
    "greedy": (dict(slots=2, max_len=32), _plain),
    "sampled": (dict(slots=4, max_len=32), _sampled),
    "prefix": (dict(slots=2, max_len=32, n_pages=7, prefix_cache=True),
               lambda cls: _cached(cls) + _plain(cls, n=3, seed=4, uid0=7)),
    "dedup": (dict(slots=4, max_len=48, chunk_tokens=PAGE), _identical),
    "speculative": (dict(slots=4, max_len=48, speculative_k=4),
                    _repetitive),
    "pipelined": (dict(slots=4, max_len=32, pipelined=True),
                  lambda cls: _plain(cls, n=7, seed=9)),
    "preempting": (dict(slots=3, max_len=32, n_pages=6),
                   lambda cls: _plain(cls, n=5, max_new=10, lo=8)),
}


def _both(weights, scenario):
    """One run of the scenario through each engine, each with its own
    tracer and registry; returns ((port engine, reqs, tracer, registry),
    (the same for JAX))."""
    kw, make = SCENARIOS[scenario]
    (jcfg, jp), (pcfg, pp) = weights
    out = []
    for engine, cls, tracer_cls, reg_cls, extra in (
            (ServeEngine, Request, Tracer, Registry,
             dict(params=pp, cfg=pcfg, device="cpu")),
            (JaxEngine, JaxRequest, jax_trace.Tracer, jax_metrics.Registry,
             dict(params=jp, cfg=jcfg, weight_plan=False))):
        trc, reg = tracer_cls(), reg_cls()
        cfg, params = extra.pop("cfg"), extra.pop("params")
        eng = engine(cfg, params, page_size=PAGE, tracer=trc, metrics=reg,
                     **kw, **extra)
        reqs = eng.run(make(cls))
        out.append((eng, reqs, trc, reg))
    return out


def _stream(tracer):
    return [(e["name"], e["ph"], e.get("args", {})) for e in tracer.events
            if not e["name"].startswith(("jit/", "cost/", "step/",
                                         "device/"))]


def _totals(reg):
    """Counter and gauge values, histogram counts; no jit series."""
    out = {}
    for name, m in reg.snapshot().items():
        if name.startswith("serve_jit_"):
            continue
        for series in m["series"]:
            key = (name, tuple(sorted(series["labels"].items())))
            out[key] = series["count"] if m["type"] == "histogram" \
                else series["value"]
    return out


@pytest.fixture(scope="module")
def runs(weights):
    return {name: _both(weights, name) for name in SCENARIOS}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_trace_stream_equals_jax(runs, scenario):
    (peng, preqs, ptrc, _), (jeng, jreqs, jtrc, _) = runs[scenario]
    assert [r.out_tokens for r in preqs] == [r.out_tokens for r in jreqs]
    port, ref = _stream(ptrc), _stream(jtrc)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, f"event {i}: port {a} != jax {b}"
    names = {n for n, _, _ in port}
    assert {"round", "round/admit", "round/grant", "round/host_prep",
            "req/admitted", "req/first_token", "req/finished",
            "sched/admit", "pool/pages", "sched/queue"} <= names
    want = {"prefix": {"cache/published", "cache/evicted",
                       "sched/miss_wait"},
            "dedup": {"sched/dedup_wait"},
            "pipelined": {"round/dispatch", "round/retire"},
            "preempting": {"req/preempted", "sched/preempt"}}
    assert want.get(scenario, set()) <= names


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_registry_totals_equal_jax(runs, scenario):
    (peng, _, _, preg), (jeng, _, _, jreg) = runs[scenario]
    assert _totals(preg) == _totals(jreg)
    assert set(peng.stats.phase_seconds) == set(jeng.stats.phase_seconds)
    for f in ("rounds", "tokens_out", "prefill_kv_pages_written",
              "page_op_round_trips_saved"):
        assert getattr(peng.stats, f) == getattr(jeng.stats, f), f


def _check_phase_spans(events):
    """Round phase spans do not overlap within a thread, and those that
    imply a completed round sit inside a ``round`` span (a pipelined
    retire lands in the next round's window, as in JAX)."""
    phases = [e for e in events if e["ph"] == "X"
              and e["name"].startswith("round/")]
    rounds = [e for e in events if e["ph"] == "X" and e["name"] == "round"]
    assert phases and rounds
    by_tid = {}
    for e in phases:
        by_tid.setdefault(e["tid"], []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: e["ts"])
        for a, b in zip(evs, evs[1:]):
            assert a["ts"] + a["dur"] <= b["ts"] + 1.0, \
                f"{a['name']} overlaps {b['name']}"
    for e in phases:
        if e["name"] in ("round/host_prep", "round/device_step",
                         "round/emit", "round/dispatch"):
            assert any(r["ts"] - 1.0 <= e["ts"] and
                       e["ts"] + e["dur"] <= r["ts"] + r["dur"] + 1.0
                       for r in rounds), f"{e['name']} outside any round"


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_conservation_and_one_first_token(runs, scenario):
    eng, out, trc, reg = runs[scenario][0]
    s = eng.stats
    assert all(r.done for r in out)
    assert s.tokens_out == sum(s.step_tokens) - s.tokens_discarded
    assert s.tokens_out == sum(len(r.out_tokens) for r in out)
    firsts = [e["args"]["uid"] for e in trc.events
              if e["name"] == "req/first_token"]
    assert sorted(firsts) == sorted(r.uid for r in out if r.out_tokens)
    finished = {e["args"]["uid"] for e in trc.events
                if e["name"] == "req/finished"}
    assert finished == {r.uid for r in out}
    _check_phase_spans(trc.events)
    assert s.rounds == sum(1 for e in trc.events
                           if e["ph"] == "X" and e["name"] == "round")
    assert s.host_seconds() > 0 and s.device_seconds() > 0
    assert s.host_seconds() + s.device_seconds() == pytest.approx(
        sum(s.phase_seconds.values()))
    assert reg.counter("serve_rounds_total").value() == s.rounds
    hist = reg.histogram("serve_phase_seconds", labels=("phase",))
    step_phases = sum(hist.count(phase=p) for p in ("round/device_step",
                                                    "round/dispatch"))
    assert step_phases == s.rounds
    # emission timestamps cover every delivered token; ITL gaps >= 0
    assert sum(len(t) for t in s.emit_times.values()) == s.tokens_out
    assert all(g >= 0 for g in s.itl_s())


STEP_PARENTS = ("round/device_step", "round/dispatch", "round/retire")


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_step_spans_and_row_counters(runs, scenario):
    """Each ``step/*`` span sits inside a step phase; one ``step/launch``
    a round, whose ``rows`` and ``live`` sum to ``step_rows`` and
    ``step_live_rows``; the live rows are the prefilled tokens, one a
    decode lane and the verified drafts; no device clock on the CPU."""
    eng, _, trc, _ = runs[scenario][0]
    s = eng.stats
    x = [e for e in trc.events if e["ph"] == "X"]
    parents = [e for e in x if e["name"] in STEP_PARENTS]
    steps = [e for e in x if e["name"].startswith("step/")]
    for e in steps:
        assert any(p["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= p["ts"] + p["dur"] + 1e-3 for p in parents), e
    launches = [e["args"] for e in steps if e["name"] == "step/launch"]
    names = [e["name"] for e in steps]
    assert len(launches) == names.count("step/stage") == s.rounds
    assert names.count("step/wait") == s.rounds
    assert sum(a["rows"] for a in launches) == s.step_rows
    assert sum(a["live"] for a in launches) == s.step_live_rows
    for a in launches:
        assert a["rows"] == a["c"] * (1 if a["solo"] else eng.slots)
        assert len(a["kv"]) <= a["rows"] // a["c"]
        assert len(a["kv"]) <= a["live"] <= len(a["kv"]) * a["c"]
    assert any(a["pipelined"] for a in launches) == (scenario == "pipelined")
    decode_lanes = sum(e["args"]["decode_lanes"] for e in x
                       if e["name"] == "round")
    assert s.step_live_rows == (s.prefill_tokens + decode_lanes
                                + s.spec_draft_tokens)
    assert not [e for e in trc.events if e["name"].startswith("device/")]
    assert s.device_busy_s is s.device_window_s is s.device_idle_s is None


def test_tracing_off_records_phases_only(weights):
    """The default tracer is disabled: phases still land in EngineStats
    and the registry, and the tracer holds nothing."""
    kw, make = SCENARIOS["greedy"]
    cfg, params = weights[1]
    reg = Registry()
    eng = ServeEngine(cfg, params, page_size=PAGE, device="cpu",
                      metrics=reg, **kw)
    eng.run(make(Request))
    assert obs_trace.get_tracer().events == []
    assert set(eng.stats.phase_seconds) >= {
        "round/admit", "round/grant", "round/host_prep",
        "round/device_step", "round/emit"}
    assert reg.counter("serve_rounds_total").value() == eng.stats.rounds
    s = eng.stats
    assert s.step_rows >= s.step_live_rows > 0       # counted untraced too
    assert s.device_busy_s is s.device_window_s is s.device_idle_s is None


# ==========================================================================
# the step set's compile events
# ==========================================================================
def test_step_set_compile_and_unexpected_retrace(weights):
    """Each new width's buffers fire one ``jit/compile`` on the process
    tracer; a second binding (a new parameter tree) re-creates them past
    the declared surface, which fires ``jit/unexpected_retrace`` and its
    counter instead of raising."""
    cfg, params = weights[1]
    trc, reg = Tracer(), Registry()
    prev_t = obs_trace.set_tracer(trc)
    prev_r = obs_metrics.set_registry(reg)
    try:
        eng = ServeEngine(cfg, params, slots=2, max_len=32, page_size=PAGE,
                          device="cpu", metrics=Registry())
        eng.run(_plain(Request, n=3))
        step = eng.step_set.step
        n_widths = step.creations + eng.step_set.solo_step.creations
        compiles = [e for e in trc.events if e["name"] == "jit/compile"]
        assert len(compiles) == n_widths >= 2
        assert {e["args"]["fn"] for e in compiles} <= {"step", "solo_step"}
        assert all(e["args"]["width"] in step.widths for e in compiles)
        c = reg.counter("serve_jit_compiles_total", labels=("fn",))
        assert c.value(fn="step") + c.value(fn="solo_step") == n_widths
        assert not [e for e in trc.events
                    if e["name"] == "jit/unexpected_retrace"]
        # rebinding to another tree re-creates every width it uses
        other = dict(eng._exec_params)
        for _ in range(len(step.widths) + 1):
            other = dict(other)
            step(other, np.zeros((2, 1), np.int32), eng._arena,
                 np.zeros(2, np.int32), np.zeros(2, np.int32), eng._samp)
        assert step.compiles > step.surface
        retr = reg.counter("serve_jit_retraces_unexpected_total",
                           labels=("fn",))
        assert retr.value(fn="step") == step.compiles - step.surface
        assert [e for e in trc.events
                if e["name"] == "jit/unexpected_retrace"]
    finally:
        obs_trace.set_tracer(prev_t)
        obs_metrics.set_registry(prev_r)


# ==========================================================================
# the CLI's four observability flags
# ==========================================================================
SMALL = ["--device", "cpu", "--requests", "3", "--prompt-len", "6",
         "--new-tokens", "4", "--weights", "fp16"]


@pytest.mark.parametrize("flag", ["trace", "metrics", "cost", "profile"])
def test_cli_obs_flags_write_valid_files(flag, tmp_path, capsys):
    args = {"trace": ["--trace-out", str(tmp_path / "t.json")],
            "metrics": ["--metrics-out", str(tmp_path / "m.json")],
            "cost": ["--cost-report"],
            "profile": ["--profile", str(tmp_path / "prof")]}[flag]
    prev_reg = obs_metrics.set_registry(Registry())
    try:
        eng = serve_cli.main(SMALL + args)
    finally:
        reg = obs_metrics.set_registry(prev_reg)
    out = capsys.readouterr().out
    s = eng.stats
    if flag == "trace":
        doc = json.loads((tmp_path / "t.json").read_text())
        names = {e["name"] for e in doc["traceEvents"]}
        assert {"round", "round/device_step", "req/first_token",
                "jit/compile", "sched/admit"} <= names
        assert not obs_trace.get_tracer().enabled   # default restored
    elif flag == "metrics":
        snap = json.loads((tmp_path / "m.json").read_text())
        assert snap["serve_rounds_total"]["series"][0]["value"] \
            == s.rounds
        assert "serve_phase_seconds" in snap
        assert reg.counter("serve_rounds_total").value() == s.rounds
    elif flag == "cost":
        rep = eng.last_cost_report
        assert rep is not None and "step/C1" in out
        assert sum(r.calls for r in rep.fns
                   if r.fn in ("step", "solo_step")) == s.rounds
    else:
        doc = json.loads((tmp_path / "prof" / "serve_trace.json")
                         .read_text())
        assert doc["traceEvents"]
    assert s.tokens_out == 12
