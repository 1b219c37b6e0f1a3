"""Serving observability: metrics, tracing, and cost attribution
(counterpart of ``repro.obs``).

Three host-side modules the serving stack records itself through:

  * ``obs.metrics`` — counters / gauges / fixed-log-bucket histograms
    with labels, behind a get-or-create :class:`~repro_torch.obs.metrics.
    Registry`; snapshot-to-JSON and Prometheus text exposition. The
    metric naming contract lives in its module docstring.
  * ``obs.trace`` — a span :class:`~repro_torch.obs.trace.Tracer`
    (context-manager API, near-zero overhead when disabled, instant
    events for point occurrences) exporting Chrome trace-event JSON
    loadable in Perfetto. The span/event naming contract lives in its
    module docstring.
  * ``obs.costs`` — per-step cost attribution: opt-in count of each step
    width's FLOPs/bytes, roofline drift on the H100 (measured wall vs
    bound), and the Eq. (3)/(4) modeled memory cost of the run's engine
    counters. Off by default (one bool branch per step-set call);
    ``launch/serve.py --cost-report`` turns it on.

The first two keep a process-default instance (``get_registry`` /
``get_tracer``), separate from the JAX package's, so deep call sites —
the step set's graph counters, scheduler wait events — need no plumbing;
engines and tests may pass explicit instances instead. ``launch/serve.py
--trace-out/--metrics-out`` turns the defaults on and writes both files
after a run.
"""
from repro_torch.obs.costs import (CostReport, FnCost,  # noqa: F401
                                   attribute, capture_enabled,
                                   enable_capture, modeled_memsys)
from repro_torch.obs.metrics import (Counter, Gauge,  # noqa: F401
                                     Histogram, Registry, get_registry,
                                     log_buckets, set_registry)
from repro_torch.obs.trace import (Tracer, active, get_tracer,  # noqa: F401
                                   set_tracer)
