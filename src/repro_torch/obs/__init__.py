"""`repro_torch.obs`: observability for the sweep stack.

Ported so far: **wall-clock spans** (`trace`) — where the *pipeline*
spends time: compile -> host-prep -> device sim -> exact verify. The
module is core-free (stdlib only): the sweep stack imports `obs`, never
the other way round. A `Tracer` is always session-owned
(`SweepSession(tracer=...)`); the only shared objects are the stateless
`NULL_TRACER` and its no-op span.

The reference's simulated timelines (`timeline`) and trace-event export
(`export`) are not ported yet.
"""
from .trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = ["NULL_TRACER", "NullTracer", "Span", "Tracer"]
