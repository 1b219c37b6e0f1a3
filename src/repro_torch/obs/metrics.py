"""Lightweight metrics registry: counters, gauges, log-bucket histograms
(a copy of ``repro.obs.metrics``; the port keeps its own process default).

The serving stack records its health through ONE of these registries —
``serve/engine.py`` (round/phase accounting, admissions, page ops),
``serve/steps.py`` (graph capture / width creation counters) and
``launch/serve.py`` (``--metrics-out`` snapshot) all write here. Pure
host-side Python: no torch imports, no device work, safe to call from
inside the engine's round loop (a counter ``inc`` is one dict lookup +
add).

Naming contract (the JAX package's, with the port's meanings)
-------------------------------------------------------------
Metric names are ``serve_<noun>_<unit-or-total>`` with Prometheus
conventions: monotonic counts end in ``_total``, durations are base-unit
seconds. The instruments the serving stack registers:

  * ``serve_rounds_total``                — engine rounds executed
  * ``serve_tokens_total{kind}``          — ``emitted`` | ``discarded``
  * ``serve_admissions_total{kind}``      — ``miss`` | ``hit`` | ``dedup``
  * ``serve_preemptions_total``           — recompute-style evictions
  * ``serve_page_ops_total{op}``          — host↔device page-op round
    trips: ``adopt`` | ``page_copy`` | ``tables_rebuild`` | ``cow`` |
    ``cache_evict`` | ``fused_flush``
  * ``serve_phase_seconds{phase}``        — histogram of per-round phase
    wall time, one label value per span name in ``obs/trace.py``'s
    contract (``round/admit`` ... ``round/emit``)
  * ``serve_jit_compiles_total{fn}``      — step-set growth per step
    callable (``step`` / ``solo_step``): a CUDA graph captured for a new
    (width, head) pair on the card, a width's static buffers created on
    the CPU or with ``cuda_graphs=False`` (the port has no jit; these
    are what one costs)
  * ``serve_jit_retraces_unexpected_total{fn}`` — growth beyond a step
    callable's declared surface (two heads per width graphed, one
    buffer set per width eager): the late-flag-flip bug class

The ``serve_cost_*`` family (written by ``obs/costs.py:flush_metrics``
only when cost capture ran — see that module). ``fn`` labels are
``<step-fn>/<shape-key>``, e.g. ``step/C1`` / ``step/C16``:

  * ``serve_cost_flops_total{fn}``        — counted FLOPs executed (the
    step's projections, attention and lm_head at that width)
  * ``serve_cost_bytes_total{fn}``        — counted bytes moved
  * ``serve_cost_drift_ratio{fn}``        — gauge: measured wall /
    roofline bound per fn/shape; SUPPRESSED (not set) for rows with no
    count (the page ops), so no row ever reports a fake drift of 0
  * ``serve_cost_modeled_bytes_per_token``     — gauge: Eq. (3)/(4)
    modeled memory traffic per emitted token
  * ``serve_cost_modeled_energy_j{system}``    — gauge: modeled
    per-round energy, ``system`` in ``hetero`` | ``conventional``
  * ``serve_cost_modeled_latency_s{system}``   — gauge: modeled
    per-round latency, same label values

Snapshots serialize two ways: :meth:`Registry.snapshot` (JSON-able dict,
written by ``--metrics-out``) and :meth:`Registry.to_prometheus` (text
exposition format, scrapeable once an HTTP front door exists).
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple


def log_buckets(lo: float = 1e-6, factor: float = 4.0,
                count: int = 12) -> Tuple[float, ...]:
    """Fixed log-spaced histogram bounds: ``lo * factor**k``.

    The default (1 µs · 4^k, 12 bounds) spans 1 µs .. ~4.2 s — wide
    enough for host phase slivers and cold graph captures alike, at 12
    ints of storage per label set."""
    return tuple(lo * factor ** k for k in range(count))


def _label_values(label_names: Sequence[str], labels: dict,
                  metric: str) -> Tuple[str, ...]:
    if set(labels) != set(label_names):
        raise ValueError(
            f"{metric}: got labels {sorted(labels)}, declared "
            f"{sorted(label_names)}")
    return tuple(str(labels[k]) for k in label_names)


class Counter:
    """Monotonically increasing count, optionally per label set."""

    def __init__(self, name: str, help: str, label_names: Sequence[str]):
        self.name, self.help = name, help
        self.label_names = tuple(label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (n={n})")
        key = _label_values(self.label_names, labels, self.name)
        self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels) -> float:
        return self._values.get(
            _label_values(self.label_names, labels, self.name), 0)


class Gauge:
    """Point-in-time value (set/add), optionally per label set."""

    def __init__(self, name: str, help: str, label_names: Sequence[str]):
        self.name, self.help = name, help
        self.label_names = tuple(label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, v: float, **labels) -> None:
        self._values[_label_values(self.label_names, labels,
                                   self.name)] = v

    def add(self, n: float, **labels) -> None:
        key = _label_values(self.label_names, labels, self.name)
        self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels) -> float:
        return self._values.get(
            _label_values(self.label_names, labels, self.name), 0)


class Histogram:
    """Fixed-bound histogram (cumulative buckets + sum + count).

    Bounds are upper-inclusive like Prometheus ``le``; one implicit
    ``+Inf`` bucket catches the tail. Use :func:`log_buckets` for the
    standard log-spaced seconds bounds."""

    def __init__(self, name: str, help: str, label_names: Sequence[str],
                 buckets: Sequence[float]):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != \
                len(tuple(buckets)):
            raise ValueError(f"{name}: bucket bounds must be strictly "
                             f"increasing, got {tuple(buckets)}")
        self.name, self.help = name, help
        self.label_names = tuple(label_names)
        self.buckets = tuple(float(b) for b in buckets)
        # per label set: [counts per bound + inf, sum, n]
        self._series: Dict[Tuple[str, ...], List] = {}

    def _row(self, key):
        row = self._series.get(key)
        if row is None:
            row = [[0] * (len(self.buckets) + 1), 0.0, 0]
            self._series[key] = row
        return row

    def observe(self, v: float, **labels) -> None:
        row = self._row(_label_values(self.label_names, labels, self.name))
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):
            if v <= b:
                i = j
                break
        row[0][i] += 1
        row[1] += v
        row[2] += 1

    def count(self, **labels) -> int:
        key = _label_values(self.label_names, labels, self.name)
        return self._series[key][2] if key in self._series else 0

    def sum(self, **labels) -> float:
        key = _label_values(self.label_names, labels, self.name)
        return self._series[key][1] if key in self._series else 0.0


class Registry:
    """Get-or-create home for named instruments.

    Re-registering a name returns the existing instrument — and raises if
    the type, labels or buckets disagree, so two instrumentation sites
    can never silently split one logical metric."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, label_names, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, label_names, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) or m.label_names != tuple(label_names) \
                or kw.get("buckets") is not None \
                and m.buckets != tuple(kw["buckets"]):
            raise ValueError(
                f"metric {name!r} re-registered with a different "
                f"type/labels/buckets")
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         buckets=tuple(buckets or log_buckets()))

    def reset(self) -> None:
        """Drop every instrument (tests / fresh measurement windows)."""
        with self._lock:
            self._metrics.clear()

    # ---- export --------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able view: every instrument with all its label series."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            entry = {"type": type(m).__name__.lower(), "help": m.help,
                     "labels": list(m.label_names)}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
                entry["series"] = [
                    {"labels": dict(zip(m.label_names, key)),
                     "counts": list(row[0]), "sum": row[1],
                     "count": row[2]}
                    for key, row in sorted(m._series.items())]
            else:
                entry["series"] = [
                    {"labels": dict(zip(m.label_names, key)), "value": v}
                    for key, v in sorted(m._values.items())]
            out[name] = entry
        return out

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)

    def to_prometheus(self) -> str:
        """Text exposition format (one scrape body)."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            kind = {"Counter": "counter", "Gauge": "gauge",
                    "Histogram": "histogram"}[type(m).__name__]
            if m.help:
                lines.append(f"# HELP {name} {_esc_help(m.help)}")
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(m, Histogram):
                for key, row in sorted(m._series.items()):
                    cum = 0
                    for b, c in zip(m.buckets, row[0]):
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{_labels(m.label_names, key, le=_fmt(b))}"
                            f" {cum}")
                    cum += row[0][-1]
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels(m.label_names, key, le='+Inf')} {cum}")
                    lines.append(
                        f"{name}_sum{_labels(m.label_names, key)}"
                        f" {_fmt(row[1])}")
                    lines.append(
                        f"{name}_count{_labels(m.label_names, key)}"
                        f" {row[2]}")
            else:
                for key, v in sorted(m._values.items()):
                    lines.append(
                        f"{name}{_labels(m.label_names, key)} {_fmt(v)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _esc_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _esc_label(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _labels(names: Sequence[str], values: Sequence[str], **extra) -> str:
    pairs = [(n, v) for n, v in zip(names, values)] + list(extra.items())
    if not pairs:
        return ""
    body = ",".join(f'{n}="{_esc_label(str(v))}"' for n, v in pairs)
    return "{" + body + "}"


# ---------------------------------------------------------------------------
# process-default registry: instrumentation sites that are not handed an
# explicit registry (deep call sites like the steps.py graph counters)
# write here; ``launch/serve.py --metrics-out`` snapshots it.
# ---------------------------------------------------------------------------
_DEFAULT = Registry()


def get_registry() -> Registry:
    return _DEFAULT


def set_registry(reg: Registry) -> Registry:
    """Swap the process-default registry; returns the previous one."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, reg
    return prev
