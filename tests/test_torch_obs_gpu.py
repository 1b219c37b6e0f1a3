"""The engine's device clock on the card (``repro_torch.obs.trace``: the
``device/*`` spans, their anchor and ``idle_by_span``) against
``torch.profiler``'s CUDA activity and against the host's clock.

The profiler's clock is tied to the tracer's twice (``_profiled``):

  * on the device: a marker kernel, queued behind a spin so that the
    event after it is queued before it ends, inside a program device span
    of its own; its end and the span's end are the same device moment.
    This tie asks where the program's spans lie among the device's work,
    whatever their clock's tie to the host;
  * on the host: one fill kernel and an event after it, which the host
    polls until done and then stamps with a tracer instant (of three
    such markers, the one polled fastest). The two ties differ by the
    program's anchor offset plus this tie's own lag. (A tie by the fill's
    host-side operator, with CPU activity, placed the device's work
    150-220 us early on an H100 machine.)

Every test needs a CUDA card and skips without one; this file imports no
JAX, so on a machine with a card it runs alone:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_obs_gpu.py

  * a small graphed engine at ``tests/conftest.py:SERVE_BASE`` width (hd
    32, which the attention kernel takes), synchronous and pipelined: at
    least 99% of the profiler's kernel time lies inside the program's
    ``device/*`` spans (tied on the device), every copy within 20 us of
    one, and the run's idle charges sum to its window less its busy time
    within 0.1%;
  * the anchor: the two ties agree within 50 us; lone kernels, each in
    its own device span: the span's end lies within 50 us of the profiled
    kernel's end (tied on the host), and its start before the kernel's;
    on the host's clock the span opens after the host enqueued it and
    closes before the host sees it done, by under 50 us;
  * two kernels 5 ms apart, the host spinning for 5 ms inside a named
    span between them: the gap reads 5 +- 0.2 ms, charged to that
    span."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

pytestmark = pytest.mark.gpu

MARK = "test/marker"
# tests/conftest.py:SERVE_BASE, with an explicit head size the kernel takes
SERVE_BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _profiled(fn, trc: Tracer):
    """Runs ``fn`` under ``torch.profiler`` (CUDA activity alone, as the
    benchmark records it) behind the two markers (module docstring).
    Returns ``fn``'s device activities as (start, end, name) in profiler
    microseconds, and the ties' offsets (profiler us - tracer us) by
    name, ``device`` and ``host``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        trc.device_anchor()
        with trc.device_span("device/marker"):
            torch.cuda._sleep(1_000_000)
            torch.full((1,), 1.0, device="cuda")
        span = trc.resolve_device()[0]
        for _ in range(3):
            torch.cuda.synchronize()
            torch.full((1,), 1.0, device="cuda")
            done = torch.cuda.Event()
            done.record()
            while not done.query():
                pass
            trc.instant(MARK)
        fn()
        torch.cuda.synchronize()
    acts = sorted((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns())
                   / 1e3, e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and "Sync" not in e.name())     # host waits, not work
    fills, acts = acts[1:5], acts[5:]
    assert all("Fill" in n for _, _, n in fills), fills
    marks = [e["ts"] for e in trc.events if e["name"] == MARK]
    # each host marker's instant is late by its poll: the largest offset
    # is the closest
    offs = {"device": fills[0][1] - (span["ts"] + span["dur"]),
            "host": max(b - m for (_, b, _), m in zip(fills[1:], marks))}
    print("ties: host - device %.1f us; host polls' excess (us) %s"
          % (offs["host"] - offs["device"],
             [round(offs["host"] - (b - m), 1)
              for (_, b, _), m in zip(fills[1:], marks)]))
    return acts, offs


def _requests():
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(3)
    return [Request(uid=i, prompt=rng.integers(2, 64, int(n)).astype(
        np.int32), max_new_tokens=int(m))
        for i, (n, m) in enumerate(zip(rng.integers(3, 60, 7),
                                       rng.integers(2, 12, 7)))]


def _inside(acts, spans) -> float:
    """Device time of ``acts`` that lies inside the union of ``spans``."""
    cover = obs_trace.union(spans, -np.inf, np.inf)
    return sum(max(0.0, min(b, d) - max(a, c))
               for a, b, _ in acts for c, d in cover)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_device_spans_cover_the_profiled_kernels(card, pipelined):
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine
    cfg = ModelConfig(name="t", family="dense", head_dim=32, **SERVE_BASE)
    trc = Tracer()
    eng = ServeEngine(cfg, init_params(cfg, 0, device="cuda"), slots=3,
                      max_len=64, page_size=16, device="cuda",
                      pipelined=pipelined, tracer=trc)
    eng.run(_requests())                       # captures every width
    trc.clear()
    acts, offs = _profiled(lambda: eng.run(_requests()), trc)
    acts = [(a - offs["device"], b - offs["device"], n) for a, b, n in acts]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in trc.events
             if e["name"] in ("device/step", "device/page_ops")]
    assert {e["tid"] for e in trc.events if e["name"].startswith(
        "device/")} == {obs_trace.DEVICE_TID}
    assert sum(e["name"] == "device/step" for e in trc.events) \
        == eng.stats.rounds
    copies = [x for x in acts if x[2].startswith(("Memcpy", "Memset"))]
    kernels = [x for x in acts if x not in copies]
    total = sum(b - a for a, b, _ in kernels)
    inside = _inside(kernels, spans)
    print(f"kernel time inside the spans {inside / total:.4%}")
    assert total > 0 and inside >= 0.99 * total
    # the readback's copies end on the profiler's clock up to 11.1 us past
    # the span's closing event (an H100 machine), though the stream orders
    # that event after them: its copy timestamps run that far from the
    # events'. Each copy still lies within 20 us of a span.
    cover = obs_trace.union(spans, -np.inf, np.inf)
    out = [min(max(0.0, c - a, b - d) for c, d in cover)
           for a, b, _ in copies]
    print(f"copies {len(copies)}, the most outside a span {max(out):.1f} us")
    assert max(out) < 20, [x for x, o in zip(copies, out) if o >= 20]
    s = eng.stats
    assert 0 < s.device_busy_s < s.device_window_s
    assert sum(s.device_idle_s.values()) == pytest.approx(
        s.device_window_s - s.device_busy_s, rel=1e-3)
    busy_prof = sum(b - a for a, b in obs_trace.union(
        [(a, b) for a, b, _ in acts], -np.inf, np.inf)) * 1e-6
    assert s.device_busy_s >= 0.99 * busy_prof


def _spin(seconds: float) -> None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def test_device_clock_matches_the_profiler(card):
    """Lone kernels, each in its own device span with the device idle
    before it: the span closes within 50 us of the profiled kernel's end
    and opens before its start; on the host's clock it opens after the
    host enqueued it and closes under 50 us before the host, polling an
    event behind it, sees it done (the kernel is loaded before, so no lazy
    module load sits inside a span)."""
    trc = Tracer()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()

    def probe():
        trc.device_anchor()
        for _ in range(3):
            time.sleep(0.002)
            trc.instant("test/enqueue")
            with trc.device_span("device/probe"):
                torch.cuda._sleep(200_000)
            done = torch.cuda.Event()
            done.record()
            while not done.query():
                pass
            trc.instant("test/seen")
        trc.resolve_device()

    acts, offs = _profiled(probe, trc)
    assert abs(offs["host"] - offs["device"]) < 50, offs
    acts = [(a - offs["host"], b - offs["host"], n) for a, b, n in acts]
    spans = [e for e in trc.events if e["name"] == "device/probe"]
    host = {k: [e["ts"] for e in trc.events if e["name"] == k]
            for k in ("test/enqueue", "test/seen")}
    assert len(acts) == len(spans) == 3, (acts, spans)
    for (a, b, _), e, t_enq, t_seen in zip(acts, spans, host["test/enqueue"],
                                           host["test/seen"]):
        end = e["ts"] + e["dur"]
        print(f"span end - kernel end {end - b:.1f} us, span start - kernel"
              f" start {e['ts'] - a:.1f} us, seen - span end "
              f"{t_seen - end:.1f} us")
        assert abs(end - b) < 50 and e["ts"] < a + 50, (e, a, b)
        assert t_enq < e["ts"] and 0 < t_seen - end < 50, (e, t_enq, t_seen)


def test_idle_gap_charged_to_the_host_span(card):
    x = torch.zeros(1024, device="cuda")
    trc = Tracer()
    trc.device_anchor()
    with trc.device_span("device/a"):
        x.add_(1)
    with trc.span("host/sleep"):
        _spin(0.005)
    with trc.device_span("device/b"):
        x.add_(1)
    a, b = trc.resolve_device()
    t0, t1 = a["ts"], b["ts"] + b["dur"]
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in trc.events
            if e["name"] == "host/sleep"]
    idle = obs_trace.idle_by_span(host, [(e["ts"], e["ts"] + e["dur"])
                                         for e in (a, b)], t0, t1)
    assert idle["host/sleep"] == pytest.approx(5000, abs=200)
    assert idle["host/sleep"] == pytest.approx(host[0][1] - host[0][0],
                                               abs=20)
    gap = b["ts"] - (a["ts"] + a["dur"])
    assert sum(idle.values()) == pytest.approx(gap)
