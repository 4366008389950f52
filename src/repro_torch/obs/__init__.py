"""repro_torch.obs — unified tracing + metrics for the serving stack.

Two cooperating pieces:

- :mod:`repro_torch.obs.trace` — a :class:`Tracer` recording spans / instants /
  counter points into per-thread ring buffers, exported as Chrome
  trace-event JSON that loads in https://ui.perfetto.dev. Disabled by
  default via a no-op singleton, so instrumentation sites cost ~a no-op
  method call when tracing is off (gated <1% of step time by
  ``benchmarks/obs_overhead.py``; <5% enabled).
- :mod:`repro_torch.obs.metrics` — a :class:`MetricsRegistry` of counters,
  gauges, and log-bucketed histograms with ``snapshot()``/``delta()``
  semantics. Existing stat objects register gauge callables into it.

Typical capture::

    from repro_torch.obs import enable_tracing
    tracer = enable_tracing()
    ...   # run the server / engine
    tracer.export("trace.json")   # open in ui.perfetto.dev
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               get_metrics, set_metrics)
from repro_torch.obs.timeline import request_timeline
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer, disable_tracing,
                             enable_tracing, get_tracer, set_tracer)

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "get_tracer",
    "set_tracer",
    "enable_tracing",
    "disable_tracing",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_metrics",
    "set_metrics",
    "request_timeline",
]
