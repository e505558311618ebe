"""Span tracing: lightweight wall-clock instrumentation for the sweep
pipeline (docs/observability.md).

A `Tracer` records `Span`s — named `perf_counter` intervals tagged with
a *track* (which process: the host, or a multiproc worker) and a *phase*
(which pipeline stage: compile / host-prep / device-sim / exact-verify /
dispatch / merge). Spans are stored relative to the tracer's epoch so a
worker process can record against its own local tracer and ship the
spans back as plain tuples; the parent re-bases them onto its clock with
`absorb` under the worker's own track id.

The default everywhere is `NULL_TRACER`, a stateless no-op whose
``span()`` returns a shared do-nothing context manager: with tracing
off, the instrumented code paths execute the identical sequence of
engine/cache operations (counter-asserted by tests/test_obs.py — zero
extra compiles, zero extra batch calls, bit-identical results), and the
per-call overhead is one attribute lookup and an empty ``with`` block.

Request scope: ``with tracer.request(rid):`` tags every span the
current thread records inside it with ``("req", rid)`` in its meta, and
`Tracer.record` files an interval whose ends were taken in different
threads (both on `Tracer.clock`). A span's parent is the innermost span
of the same ``req`` that encloses it on the same track; spans carry no
parent field.

Ownership rule (enforced by tools/check_no_global_state.py): a *real*
`Tracer` is mutable state and therefore always session-owned — passed
in via ``SweepSession(tracer=...)`` — never a module-level singleton.
`NULL_TRACER` records nothing, so sharing one instance process-wide is
sound.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, List, Tuple

# the tuple layout spans travel in across the multiproc pickle boundary:
# (name, start_s, dur_s, phase, meta-kv-pairs) — track is assigned by the
# absorbing parent (the worker does not know its parent-side identity)
WireSpan = Tuple[str, float, float, str, Tuple[Tuple[str, Any], ...]]


@dataclass(frozen=True)
class Span:
    """One named wall-clock interval, relative to its tracer's epoch."""

    name: str
    start: float                  # seconds since the tracer's epoch
    dur: float                    # seconds
    track: str = "host"           # which process recorded it (Perfetto pid)
    phase: str = ""               # pipeline stage (Perfetto tid)
    meta: Tuple[Tuple[str, Any], ...] = ()

    @property
    def end(self) -> float:
        return self.start + self.dur

    def to_wire(self) -> WireSpan:
        """Track-free tuple form for the multiproc result payload."""
        return (self.name, self.start, self.dur, self.phase, self.meta)


class _SpanCtx:
    """Context manager for one in-flight span; records on exit."""

    __slots__ = ("_tracer", "_name", "_phase", "_meta", "_t0")

    def __init__(self, tracer: "Tracer", name: str, phase: str,
                 meta: Tuple[Tuple[str, Any], ...]):
        self._tracer = tracer
        self._name = name
        self._phase = phase
        self._meta = meta
        self._t0 = 0.0

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self._tracer._record(self._name, self._t0, t1 - self._t0,
                             self._phase, self._meta)


class _NullSpanCtx:
    """The do-nothing span `NullTracer` hands out (one shared instance —
    it holds no state, so reentrancy and concurrency are free)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpanCtx":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpanCtx()


class Tracer:
    """Thread-safe span recorder with a fixed epoch.

    ``span(name, phase=..., **meta)`` is the one instrumentation point:

        with tracer.span("sim[256x64]", phase="device-sim", rows=48):
            ...

    Spans are appended in completion order under a lock (worker threads
    and the multiproc result loop may interleave); `spans()` returns a
    stable snapshot. ``track`` names the process this tracer belongs to
    — the parent session's tracer is ``"host"``, worker-local tracers
    are re-based into the parent under their worker name by `absorb`.
    """

    enabled = True
    # the clock every span is taken on; `record` takes its ends from it
    clock = staticmethod(time.perf_counter)

    def __init__(self, track: str = "host"):
        self.track = track
        self._epoch = time.perf_counter()
        self._spans: List[Span] = []
        self._mu = threading.Lock()
        self._scope = threading.local()    # .req: this thread's request id

    # -- recording -------------------------------------------------------------
    def span(self, name: str, *, phase: str = "", **meta) -> _SpanCtx:
        return _SpanCtx(self, name, phase, tuple(sorted(meta.items())))

    def record(self, name: str, t0: float, t1: float, *, phase: str = "",
               **meta) -> None:
        """An interval whose ends were read from `clock` elsewhere, such
        as a queue wait that starts in one thread and ends in another."""
        self._record(name, t0, t1 - t0, phase, tuple(sorted(meta.items())))

    @contextlib.contextmanager
    def request(self, rid: Any) -> Iterator[None]:
        """Tag every span this thread records inside with ``req=rid``
        (a span given its own ``req`` keeps it). Thread-local: work
        handed to another thread carries the id explicitly."""
        outer = getattr(self._scope, "req", None)
        self._scope.req = rid
        try:
            yield
        finally:
            self._scope.req = outer

    def current_request(self) -> Any:
        """The request id this thread records under (None outside)."""
        return getattr(self._scope, "req", None)

    def _record(self, name: str, t0_abs: float, dur: float, phase: str,
                meta: Tuple[Tuple[str, Any], ...]) -> None:
        rid = getattr(self._scope, "req", None)
        if rid is not None and all(k != "req" for k, _ in meta):
            meta = tuple(sorted(meta + (("req", rid),)))
        s = Span(name=name, start=t0_abs - self._epoch, dur=dur,
                 track=self.track, phase=phase, meta=meta)
        with self._mu:
            self._spans.append(s)

    def now(self) -> float:
        """Seconds since this tracer's epoch (for re-basing absorbs)."""
        return time.perf_counter() - self._epoch

    # -- reading / merging -----------------------------------------------------
    def spans(self) -> Tuple[Span, ...]:
        with self._mu:
            return tuple(self._spans)

    def clear(self) -> None:
        with self._mu:
            self._spans.clear()

    def absorb(self, wire_spans: Iterable[WireSpan], *, offset: float,
               track: str) -> None:
        """Merge spans shipped back from another process: each wire span
        is re-based onto this tracer's clock (``offset`` seconds past
        this epoch = the foreign epoch) and filed under ``track`` — the
        absorbing caller assigns disjoint per-worker track ids. Input
        order is preserved, so absorbing items in id order keeps the
        merged sequence deterministic regardless of queue interleaving.
        """
        merged = [Span(name=n, start=offset + st, dur=d, track=track,
                       phase=ph, meta=tuple(meta))
                  for n, st, d, ph, meta in wire_spans]
        with self._mu:
            self._spans.extend(merged)

    def wire_spans(self) -> List[WireSpan]:
        """Every span in track-free tuple form (the worker's return
        payload)."""
        return [s.to_wire() for s in self.spans()]


class NullTracer:
    """No-op `Tracer` stand-in: the default wherever a tracer is
    threaded. Records nothing, allocates nothing per call, and keeps
    every ``with tracer.span(...)`` site valid."""

    enabled = False
    track = "null"
    clock = staticmethod(time.perf_counter)

    def span(self, name: str, *, phase: str = "", **meta) -> _NullSpanCtx:
        return _NULL_SPAN

    def record(self, name: str, t0: float, t1: float, *, phase: str = "",
               **meta) -> None:
        return None

    def request(self, rid: Any) -> _NullSpanCtx:
        return _NULL_SPAN

    def current_request(self) -> Any:
        return None

    def now(self) -> float:
        return 0.0

    def spans(self) -> Tuple[Span, ...]:
        return ()

    def clear(self) -> None:
        return None

    def absorb(self, wire_spans: Iterable[WireSpan], *, offset: float,
               track: str) -> None:
        return None

    def wire_spans(self) -> List[WireSpan]:
        return []


# The shared stateless no-op default (see module docstring): real Tracers
# are session-owned; this one records nothing, so one instance is safe.
NULL_TRACER = NullTracer()
