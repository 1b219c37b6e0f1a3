"""Span tracer exporting Chrome trace-event JSON (Perfetto-loadable): a
copy of ``repro.obs.trace`` (the port keeps its own process default).

One :class:`Tracer` records the serving stack's phase structure as
complete ("X") duration events plus instant ("i") point events, in the
Chrome ``traceEvents`` format — load the exported file in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``. Timestamps are
microseconds from the tracer's construction (``time.perf_counter``
based), one track per Python thread, and on the card one ``device``
track read from CUDA events (below). Tracing a round costs a handful of
``perf_counter`` calls and dict appends, and on the card three pairs of
event records at most; a *disabled* tracer costs one branch per call
site. No call of this module may run
inside a ``torch.cuda.graph`` capture: the step set's graphs hold device
work only, and every span, instant and counter is recorded around them.

Span / event naming contract (what later PRs must follow)
---------------------------------------------------------
Engine round phases — complete events, one per round, non-overlapping
and strictly inside their round's wall window, emitted by
``serve/engine.py``:

  * ``round/admit``        — scheduler round start + admissions: prefix
    /dedup matching, page adopts, COW ``page_copy`` dispatches and SSM
    ``reset_state`` dispatches for newly seated requests.
  * ``round/grant``        — chunk-budget grants + page allocation for
    every planned lane, including eviction/preemption fallout.
  * ``round/host_prep``    — building the step's host arrays (tokens /
    start / n_new), gather-work accounting and the page-ops flush
    (block-table validation, COW copies + host→device upload).
  * ``round/device_step``  — the step call (on the card, the staging
    upload and one graph replay) and the readback of its selected tokens
    and logprobs, ending after the readback event has been waited on, so
    device time never shows as host time; on a new width this span
    absorbs the capture (see ``jit/compile`` instants).
  * ``round/emit``         — token emission, stats, streaming callbacks,
    publish/finish/requeue bookkeeping.

Pipelined engines (``ServeEngine(pipelined=True)``) add two phases and
relax the window rule for one of them:

  * ``round/dispatch``     — the step call of an overlapped round:
    device-token carry, staging upload, graph replay and the start of a
    non-blocking readback behind an event, NO wait (that is the point).
    On the CPU the step runs eagerly inside it, so ``EngineStats``
    charges this span as device time, not host work.
  * ``round/retire``       — the wait on the PREVIOUS round's readback
    event and its emission. A pipelined retire necessarily lands inside the
    NEXT round's wall window — the one sanctioned exception to the
    "strictly inside their round" rule above; synchronous engines never
    emit these two spans and keep the original contract bit-for-bit.

Request lifecycle — instant events with ``uid`` (and ``slot``) args,
emitted by ``serve/engine.py``:

  * ``req/admitted``    — seated into a slot (args: cached prompt tokens
    adopted, dedup flag).
  * ``req/chunk_done``  — one prefill chunk scattered (args: pos after).
  * ``req/first_token`` — first emission; exactly ONCE per request even
    across preemption/recompute (TTFT's clock rule).
  * ``req/preempted``   — recompute-style eviction; emitted tokens were
    discarded.
  * ``req/finished``    — terminal emission (args: n tokens out).

Scheduler / cache / jit events:

  * ``sched/dedup_wait`` — admission head waiting for an in-flight
    identical prompt's prefill (``serve/scheduler.py``).
  * ``sched/miss_wait``  — admission head serialized behind the one
    open prefix-cache miss (``serve/scheduler.py``).
  * ``cache/published``  — prefill pages inserted into the radix index
    (``serve/prefix_cache.py``; args: n new pages).
  * ``cache/evicted``    — index pages LRU-evicted under pressure
    (``serve/prefix_cache.py``; args: n pages).
  * ``jit/compile``      — the port has no jit: the step set captured a
    CUDA graph for a new (width, head) pair, or (on the CPU, or with
    ``cuda_graphs=False``) created a new width's static buffers
    (``serve/steps.py``; args: fn, width, seconds of the capture or
    creation).
  * ``jit/unexpected_retrace`` — growth beyond the step callable's
    declared surface: the late-flag-flip bug class, surfaced instead of
    silently stalling a round 10x.

The step call's pieces (port-only, no counterpart in the JAX trace) —
complete events on an enabled tracer, nested inside ``round/device_step``,
``round/dispatch`` or ``round/retire``, never ``phase_seconds`` keys
(``serve/engine.py``):

  * ``step/stage``   — ``GraphedStep.stage``: packing the round's inputs
    into pinned staging and enqueuing their upload.
  * ``step/launch``  — the graph replay (on the CPU, or with
    ``cuda_graphs=False``, the eager run) and the enqueue of the readback
    copy; args: ``c`` (the width), ``rows`` (lanes run x C), ``live``
    (Σ ``n_new``), ``solo``, ``pipelined`` (the round enters the
    pipeline), ``kv`` (each live lane's ``start + n_new``).
  * ``step/wait``    — the host waiting on the readback event (nothing to
    wait on on the CPU), in a synchronous round and in a pipelined retire.

The device's clock (port-only; on the card with an enabled tracer, nothing
on the CPU) — complete events on the ``device`` track (``tid``
:data:`DEVICE_TID`), in the tracer's microseconds:

  * ``device/step``      — one round's device work, from the staging upload
    through the readback copy.
  * ``device/page_ops``  — a page-ops flush that enqueued anything (copies,
    resets, block tables).

  Each is a pair of timing CUDA events on the current stream
  (:meth:`Tracer.device_span`), taken from a pool reused across runs. The
  engine anchors the clock at the start of each traced run
  (:meth:`Tracer.device_anchor`: ``torch.cuda.synchronize()``, one event,
  ``perf_counter`` read beside it) and turns the pairs into events at its
  end (:meth:`Tracer.resolve_device`): device time is the anchor's host
  time plus the events' elapsed time from it. A ``torch.profiler`` window
  tied to the tracer by a marker kernel reads on the same clock.
  :func:`idle_by_span` charges the device's idle time to the innermost
  host span open over it (``EngineStats.device_idle_s``).

Counter tracks — "C" events rendering as value lanes on the timeline:

  * ``pool/pages``  — per round (``serve/engine.py``): arena pages
    ``live`` / ``free`` — pool pressure next to the phase spans.
  * ``sched/queue`` — per round (``serve/engine.py``):
    ``prefill_pending`` admission-queue depth.
  * ``cost/<fn>``   — per step-set call when ``obs.costs`` capture is
    on (``serve/steps.py``): cumulative counted ``flops`` / ``bytes``
    of that step function, e.g. ``cost/step``.
"""
from __future__ import annotations

import bisect
import heapq
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# the ``tid`` of the device track (no Python thread has ident 0)
DEVICE_TID = 0


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer, self.name, self.args = tracer, name, args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.tracer._complete(self.name, self.t0, t1 - self.t0, self.args)
        return False


class _NullDeviceSpan:
    """Shared no-op device span: a disabled tracer, or no anchored run."""

    __slots__ = ()

    def begin(self) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_DEVICE_SPAN = _NullDeviceSpan()


class _DeviceSpan:
    """A pair of timing events on the current stream: :meth:`begin` records
    the first, :meth:`end` the second (also usable as a context manager).
    A span whose ``begin`` never ran records nothing."""

    __slots__ = ("tracer", "name", "args", "i0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer, self.name, self.args = tracer, name, args
        self.i0 = None

    def begin(self) -> None:
        self.i0 = self.tracer._record_event()

    def end(self) -> None:
        if self.i0 is not None:
            self.tracer._device_pairs.append(
                (self.name, self.i0, self.tracer._record_event(), self.args))
            self.i0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Tracer:
    """Chrome-trace span/instant recorder.

    ``enabled=False`` (and the module-default tracer until someone turns
    it on) makes every recording method a constant-time no-op returning
    shared objects — instrument call sites unconditionally and let the
    flag decide. All recording is in-memory (a list of small dicts);
    :meth:`export` writes the ``{"traceEvents": [...]}`` JSON object.
    Appends are guarded by a lock only on the shared event list; the
    timestamp math is per-call-site."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: List[dict] = []
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        # the device clock: timing events reused across runs, how many the
        # current run has recorded, its (name, begin, end, args) pairs, its
        # anchor (event index, perf_counter seconds) and the stream that
        # was current at the anchor, which every event of the run records on
        self._device_events: list = []
        self._device_used = 0
        self._device_pairs: List[tuple] = []
        self._anchor: Optional[Tuple[int, float]] = None
        self._stream = None

    # ---- recording -----------------------------------------------------
    def _ts(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def span(self, name: str, **args):
        """Context manager timing a phase; records one "X" event."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def _complete(self, name: str, t0: float, dur_s: float,
                  args: dict) -> None:
        ev = {"name": name, "ph": "X", "ts": self._ts(t0),
              "dur": dur_s * 1e6, "pid": self._pid,
              "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def complete(self, name: str, t0: float, dur_s: float,
                 **args) -> None:
        """Record an already-measured span (``t0`` in perf_counter
        seconds) — for call sites that time phases themselves."""
        if self.enabled:
            self._complete(name, t0, dur_s, args)

    def instant(self, name: str, **args) -> None:
        """Record a point occurrence (thread-scoped "i" event)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": self._ts(time.perf_counter()), "pid": self._pid,
              "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def counter(self, name: str, **values) -> None:
        """Record a Chrome counter-track sample ("C" event)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "C",
              "ts": self._ts(time.perf_counter()), "pid": self._pid,
              "args": values}
        with self._lock:
            self.events.append(ev)

    # ---- the device clock ----------------------------------------------
    def device_anchor(self) -> None:
        """Start a run on the device clock: wait for the device, record an
        anchor event on the current stream (the run's device spans record
        on it too) and read ``perf_counter`` beside it. A no-op when
        disabled or without CUDA; the engine calls it at the start of each
        traced run on the card."""
        if not self.enabled:
            return
        import torch
        if not torch.cuda.is_available():
            return
        torch.cuda.synchronize()
        self._stream = torch.cuda.current_stream()
        self._device_pairs.clear()          # what an aborted run left
        self._device_used = 0
        i = self._record_event()
        self._anchor = (i, time.perf_counter())

    def device_span(self, name: str, **args):
        """A pair of timing events around device work enqueued on the
        run's stream (:class:`_DeviceSpan`); the shared no-op span when
        disabled or before :meth:`device_anchor` (so always on the CPU).
        :meth:`resolve_device` turns the pair into an "X" event."""
        if not self.enabled or self._anchor is None:
            return _NULL_DEVICE_SPAN
        return _DeviceSpan(self, name, args)

    def _record_event(self) -> int:
        import torch
        if self._device_used == len(self._device_events):
            self._device_events.append(torch.cuda.Event(enable_timing=True))
        i = self._device_used
        self._device_events[i].record(self._stream)
        self._device_used = i + 1
        return i

    def resolve_device(self) -> List[dict]:
        """End a run on the device clock: wait for its last event, append
        each pair as an "X" event on the device track (``tid``
        :data:`DEVICE_TID`) in the tracer's microseconds, and free the
        events for the next run. Returns the new events ([] without an
        anchor)."""
        if self._anchor is None:
            return []
        i_anchor, t_anchor = self._anchor
        events = self._device_events
        events[self._device_used - 1].synchronize()
        since, base = events[i_anchor].elapsed_time, self._ts(t_anchor)
        out = []
        for name, i0, i1, args in self._device_pairs:
            ts = base + 1e3 * since(events[i0])
            dur = base + 1e3 * since(events[i1]) - ts
            ev = {"name": name, "ph": "X", "ts": ts, "dur": dur,
                  "pid": self._pid, "tid": DEVICE_TID}
            if args:
                ev["args"] = args
            out.append(ev)
        with self._lock:
            self.events.extend(out)
        self._device_pairs.clear()
        self._device_used = 0
        self._anchor = self._stream = None
        return out

    # ---- export --------------------------------------------------------
    def to_json(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the event count."""
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return len(self.events)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()

    # ---- analysis helpers (bench / tests) ------------------------------
    def phase_totals(self) -> dict:
        """Summed "X"-event duration per span name, in seconds."""
        out: dict = {}
        for ev in self.events:
            if ev["ph"] == "X":
                out[ev["name"]] = out.get(ev["name"], 0.0) \
                    + ev["dur"] * 1e-6
        return out


# ---------------------------------------------------------------------------
# the device's idle time, split by the host span it overlaps
# ---------------------------------------------------------------------------
OUTSIDE = "between rounds"


def union(spans: Sequence[Tuple[float, float]], t0: float, t1: float
          ) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals clipped to ``[t0, t1]``, as
    sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted((max(a, t0), min(b, t1)) for a, b in spans
                       if b > t0 and a < t1):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        elif b > a:
            out.append((a, b))
    return out


def idle_by_span(host_spans: Sequence[Tuple[float, float, str]],
                 device_spans: Sequence[Tuple[float, float]], t0: float,
                 t1: float) -> Dict[str, float]:
    """The device's idle time in ``[t0, t1]`` (the window less the union of
    ``device_spans``), charged to the host spans ``(start, end, name)``:
    each gap is cut at every host-span boundary it crosses, and each piece
    goes to the innermost span open over it (of those open, the one begun
    last; of two begun together, the one that ends first), or to
    :data:`OUTSIDE` where none is. The charges sum to the window less the
    busy time; times in the unit given."""
    busy = union(device_spans, t0, t1)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    spans = sorted((a, b, name) for a, b, name in host_spans
                   if b > a and b > t0 and a < t1)
    cuts = sorted({x for a, b, _ in spans for x in (a, b)})
    out: Dict[str, float] = {}
    # the spans begun so far, the innermost on top (latest start, then
    # earliest end); those that have ended leave it when they surface
    heap: List[Tuple[float, float, str]] = []
    si = 0
    for g0, g1 in gaps:
        inner = cuts[bisect.bisect_right(cuts, g0):
                     bisect.bisect_left(cuts, g1)]
        for p, q in zip([g0] + inner, inner + [g1]):
            while si < len(spans) and spans[si][0] <= p:
                a, b, name = spans[si]
                heapq.heappush(heap, (-a, b, name))
                si += 1
            while heap and heap[0][1] <= p:
                heapq.heappop(heap)
            name = heap[0][2] if heap else OUTSIDE
            out[name] = out.get(name, 0.0) + (q - p)
    return out


# ---------------------------------------------------------------------------
# process-default tracer: instrumentation sites not handed an explicit
# tracer (scheduler events, steps.py graph counters, prefix-cache eviction)
# record here. Disabled until ``set_tracer`` installs an enabled one
# (``launch/serve.py --trace-out`` does), so by default every call site
# is a single-branch no-op.
# ---------------------------------------------------------------------------
_DEFAULT = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _DEFAULT


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-default tracer; returns the previous one."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, tracer
    return prev


def active(tracer: Optional[Tracer]) -> Tracer:
    """Resolve an instrumentation site's tracer: the explicit one it was
    handed, else the process default."""
    return tracer if tracer is not None else _DEFAULT
