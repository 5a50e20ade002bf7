"""repro_torch.obs — metrics registry and causal tracing.

- :mod:`repro_torch.obs.metrics` — typed ``Counter``/``Gauge``/``Histogram``
  instruments behind a :class:`MetricsRegistry`; writes take a lock per
  instrument.  :class:`ManualClock` makes timing deterministic in tests.
- :mod:`repro_torch.obs.trace` — ``Span``/``Tracer`` with per-thread
  buffers and explicit cross-thread parenting.  ``NOOP`` is the default.

The exporters (Perfetto ``trace_event`` JSON, flat metrics CSV) and the
fleet report are not ported yet.  This package is a leaf: it imports
nothing from the rest of ``repro_torch``.
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
from repro_torch.obs.trace import NOOP, NoopTracer, Span, Tracer

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
    "Span",
    "Tracer",
]
