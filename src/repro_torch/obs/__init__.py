"""Unified tracing & telemetry: span timelines, counter tracks, and
measured-vs-model reconciliation (twin of repro/obs).

  trace     — thread-aware span tracer (context-manager + decorator API,
              monotonic clocks, ring-buffered events; a disabled no-op
              singleton keeps the hot paths untouched by default)
  export    — Chrome trace-event / Perfetto JSON (schema gnn-trace/v1)
              with one track per worker/thread plus counter tracks
  aggregate — shared span/metric reductions (phase means, span stats,
              queue-vs-service request breakdown)
  reconcile — measured spans/counters/collectives held against the
              analytic cost model
"""

from .aggregate import PHASES, phase_means, request_breakdown, span_summary
from .export import (TRACE_SCHEMA, load_trace, to_chrome_trace,
                     validate_chrome_trace, write_trace)
from .trace import (CollectiveEvent, CounterEvent, PhaseClock, Span,
                    SpanEvent, Tracer, get_tracer, install, traced, tracing,
                    uninstall)

__all__ = [
    "PHASES", "phase_means", "request_breakdown", "span_summary",
    "TRACE_SCHEMA", "load_trace", "to_chrome_trace", "validate_chrome_trace",
    "write_trace",
    "CollectiveEvent", "CounterEvent", "PhaseClock", "Span", "SpanEvent",
    "Tracer", "get_tracer", "install", "traced", "tracing", "uninstall",
]
