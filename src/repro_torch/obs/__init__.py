"""repro_torch.obs — metrics registry and causal tracing.

- :mod:`repro_torch.obs.metrics` — typed ``Counter``/``Gauge``/``Histogram``
  instruments behind a :class:`MetricsRegistry`; writes take a lock per
  instrument.  :class:`ManualClock` makes timing deterministic in tests.
- :mod:`repro_torch.obs.trace` — ``Span``/``Tracer`` with per-thread
  buffers and explicit cross-thread parenting.  ``NOOP`` is the default;
  ``PROCESS_TRACER`` is the process's own, on while ``torch.profiler``
  records (or :meth:`~repro_torch.obs.trace.ProcessTracer.force` says so),
  its spans mirrored onto the profiler's timeline.

- :mod:`repro_torch.obs.export` — Perfetto/Chrome ``trace_event`` JSON,
  flat metrics JSON/CSV snapshots, span-tree validation and ASCII
  rendering.
- :mod:`repro_torch.obs.report` — ``python -m repro_torch.obs.report``
  fleet dashboard from a live ``EvalService`` or a saved snapshot.

This package is a leaf: it imports nothing from the rest of
``repro_torch``.
"""

from repro_torch.obs.metrics import (
    Clock,
    Counter,
    CounterView,
    Gauge,
    Histogram,
    ManualClock,
    MetricsRegistry,
)
from repro_torch.obs.trace import (NOOP, PROCESS_TRACER, NoopTracer,
                                   ProcessTracer, Span, Tracer)

from repro_torch.obs.export import (
    build_tree,
    completeness_errors,
    metrics_csv_lines,
    render_tree,
    trace_events,
    validate_trace_events,
    write_metrics_json,
    write_trace,
)

__all__ = [
    "Clock",
    "Counter",
    "CounterView",
    "Gauge",
    "Histogram",
    "ManualClock",
    "MetricsRegistry",
    "NOOP",
    "NoopTracer",
    "PROCESS_TRACER",
    "ProcessTracer",
    "Span",
    "Tracer",
    "build_tree",
    "completeness_errors",
    "metrics_csv_lines",
    "render_tree",
    "trace_events",
    "validate_trace_events",
    "write_metrics_json",
    "write_trace",
]
