"""Span tracer exporting Chrome trace-event JSON (Perfetto-loadable): a
copy of ``repro.obs.trace`` (the port keeps its own process default).

One :class:`Tracer` records the serving stack's phase structure as
complete ("X") duration events plus instant ("i") point events, in the
Chrome ``traceEvents`` format — load the exported file in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``. Timestamps are
microseconds from the tracer's construction (``time.perf_counter``
based), one track per Python thread. Pure host-side: tracing a round
costs a handful of ``perf_counter`` calls and dict appends; a *disabled*
tracer costs one branch per call site. No call of this module may run
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

import json
import os
import threading
import time
from typing import List, Optional


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
