"""The device's side of a traced window, from ``torch.profiler``: every
operation the device ran, the union of their intervals (busy time),
seconds by kernel name, and the idle gaps between them, each named by
the engine's phase span that was open on the host when the gap began.

The profiler records CUDA activity alone. ``chip_smoke.py``'s idle share,
of which this is a copy, also records the host's operators, which
slowed the engine's host loop by about half and so stretched the very
window it measures.

Profiler and engine tracer keep different clocks. A marker ties them:
with the device idle, a tracer instant and, right after it, one small
fill kernel, the first device operation of the trace; device times are
then read in the tracer's microseconds, late by the marker's launch
latency (microseconds)."""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

ANCHOR = "qmcbench/anchor"
PHASES = ("round/admit", "round/grant", "round/host_prep",
          "round/device_step", "round/dispatch", "round/retire",
          "round/emit")


@dataclasses.dataclass
class DeviceWindow:
    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]          # device seconds by operation name
    idle_by_phase: Dict[str, float]     # idle seconds by host phase


class Profiler:
    """Starts and stops ``torch.profiler`` around the traced waves."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.tracer.instant(ANCHOR)
        torch.full((1,), 1.0, device="cuda")
        torch.cuda.synchronize()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def events(self):
        return self.prof.profiler.kineto_results.events()


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read(kineto_events, tracer_events: List[dict], t0_us: float,
         t1_us: float) -> DeviceWindow:
    """The device window ``[t0_us, t1_us]`` (tracer microseconds)."""
    from torch.autograd import DeviceType
    first: Optional[Tuple[int, str]] = None
    spans: List[Tuple[float, float]] = []
    kernel_ns: Dict[str, int] = {}
    for e in kineto_events:
        if e.device_type() == DeviceType.CUDA:
            s, d = e.start_ns(), e.duration_ns()
            spans.append((s, s + d))
            name = e.name()
            kernel_ns[name] = kernel_ns.get(name, 0) + d
            if first is None or s < first[0]:
                first = (s, name)
    mark = [e["ts"] for e in tracer_events
            if e["ph"] == "i" and e["name"] == ANCHOR]
    if first is None or "Fill" not in first[1] or len(mark) != 1:
        raise RuntimeError("the profiler and the tracer share no marker")
    anchor_ns = first[0]
    off = anchor_ns / 1e3 - mark[0]         # profiler us - tracer us
    busy = _union([(a / 1e3 - off, b / 1e3 - off) for a, b in spans])
    busy = [(max(a, t0_us), min(b, t1_us)) for a, b in busy
            if b > t0_us and a < t1_us]
    busy_us = sum(b - a for a, b in busy)
    phases = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                    for e in tracer_events
                    if e["ph"] == "X" and e["name"] in PHASES)
    rounds = sorted((e["ts"], e["ts"] + e["dur"]) for e in tracer_events
                    if e["ph"] == "X" and e["name"] == "round")
    idle: Dict[str, float] = {}
    edges = [t0_us] + [x for ab in busy for x in ab] + [t1_us]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 > g0:
            name = _open_at(g0, phases, rounds)
            idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    return DeviceWindow(busy_s=busy_us / 1e6,
                        window_s=(t1_us - t0_us) / 1e6,
                        kernel_s={k: v / 1e9 for k, v in kernel_ns.items()},
                        idle_by_phase=idle)


def _open_at(t: float, phases, rounds) -> str:
    """The engine span open on the host at ``t``: the round phases run
    one after another on one thread, so it is the last one begun."""
    i = bisect.bisect_right(phases, (t, float("inf"), "")) - 1
    if i >= 0 and phases[i][1] >= t:
        return phases[i][2]
    j = bisect.bisect_right(rounds, (t, float("inf"))) - 1
    if j >= 0 and rounds[j][1] >= t:
        return "round (between phases)"
    return "between rounds"
