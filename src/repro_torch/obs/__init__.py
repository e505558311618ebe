"""`repro_torch.obs`: observability for the sweep stack
(docs/observability.md).

* **wall-clock spans** (`trace`) — where the *pipeline* spends time:
  compile -> host-prep -> device sim -> exact verify;
* **simulated timelines** (`timeline`) — where the *modeled run* spends
  time: per-op start/end, per-resource utilization, and the critical
  path through the micro-op DAG, whose duration equals the reported
  makespan (`torch_sim.simulate(timeline=True)`,
  `explore(timeline_top_k=...)`);
* **export** (`export`) — both rendered as Chrome-trace-event JSON
  (loadable in Perfetto / chrome://tracing) plus `metrics_snapshot()`,
  one flat queryable dict over every cache/kernel/fault counter.

The modules are core-free (stdlib + numpy only): the sweep stack imports
`obs`, never the other way round. A `Tracer` is always session-owned
(`SweepSession(tracer=...)`); the only shared objects are the stateless
`NULL_TRACER` and its no-op span (tests/test_torch_no_global_state.py
holds this package to `tools/check_no_global_state.py`).
"""
from .export import (metrics_snapshot, resource_names, spans_to_events,
                     stats_snapshot, timeline_to_events, write_trace)
from .timeline import Timeline
from .trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "NULL_TRACER", "NullTracer", "Span", "Tracer",
    "Timeline",
    "metrics_snapshot", "resource_names", "spans_to_events",
    "stats_snapshot", "timeline_to_events", "write_trace",
]
