"""Export: Chrome-trace-event JSON + the unified metrics snapshot
(docs/observability.md).

Two renderers produce events in the Chrome trace-event format that
Perfetto (https://ui.perfetto.dev) and chrome://tracing load directly:

* `spans_to_events` — wall-clock `trace.Span`s: one Perfetto *process*
  per track (host / worker), one *thread* per pipeline phase (compile,
  host-prep, device-sim, exact-verify, dispatch, merge), so the sweep
  pipeline reads as a swimlane diagram per process.
* `timeline_to_events` — a simulated `timeline.Timeline`: one Perfetto
  *thread per resource* (storage nodes, client CPUs, NICs, manager)
  under its own process, each op a complete slice named by its service
  class. Simulated seconds map to trace microseconds one-to-one.

`write_trace` wraps any mix of both in the JSON *object* form
(``{"traceEvents": [...], "otherData": {...}}``) so the metrics
snapshot rides in the same artifact.

`metrics_snapshot` flattens every counter the stack maintains —
`CacheStats`, `CompileCacheStats` (both walked via `dataclasses.fields`
so new counters flow in automatically), and the process-wide
`compile_count` ground truth — into one flat queryable dict, for
scripts that report a sweep's counters and for ad-hoc debugging.

Like the rest of `repro_torch.obs`, this module is core-free at import time:
session/stats objects are duck-typed, and the one core import
(`compile_count`) is deferred to the call.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from .timeline import Timeline
from .trace import Span

# service-class slice names, indexed by `compile.CLS_*` (kept literal so
# this module stays core-free; tests/test_obs.py pins them against the
# compile-module constants)
CLASS_NAMES = ("none", "net_remote", "net_local", "storage", "manager",
               "client", "cpu")

_US = 1e6   # seconds -> trace microseconds


def resource_names(config) -> List[str]:
    """Human labels for every resource id of one `StorageConfig`,
    following the compile-module resource map (R = 1 + 4H + S + 1):
    dummy, per-host out/in/loopback/cpu queues, per-storage-node
    service, manager. Duck-typed: anything with ``n_hosts`` and
    ``storage_hosts`` works."""
    H = int(config.n_hosts)
    names = ["dummy"]
    for kind in ("out", "in", "loop", "cpu"):
        names += [f"{kind}:h{h}" for h in range(H)]
    names += [f"storage:h{h}" for h in config.storage_hosts]
    names.append("manager")
    return names


def _ids(labels: Iterable[str], start: int = 1) -> Dict[str, int]:
    """Stable first-appearance label -> integer id assignment (the trace
    format wants numeric pids/tids; names ride in metadata events)."""
    out: Dict[str, int] = {}
    for lb in labels:
        if lb not in out:
            out[lb] = start + len(out)
    return out


def _meta_event(kind: str, pid: int, name: str, tid: int = 0) -> Dict[str, Any]:
    ev = {"ph": "M", "name": kind, "pid": pid, "args": {"name": name}}
    if kind == "thread_name":
        ev["tid"] = tid
    return ev


def spans_to_events(spans: Sequence[Span]) -> List[Dict[str, Any]]:
    """Wall-clock spans as complete ("X") trace events: pid = track
    (process), tid = phase (pipeline stage), span meta under ``args``.
    Metadata events carry the human names for both."""
    pids = _ids((s.track for s in spans), start=1)
    tids = _ids((s.phase or "main" for s in spans), start=1)
    events: List[Dict[str, Any]] = []
    for track, pid in pids.items():
        events.append(_meta_event("process_name", pid, track))
        for phase, tid in tids.items():
            events.append(_meta_event("thread_name", pid, phase, tid))
    for s in spans:
        events.append({
            "name": s.name, "ph": "X", "cat": "sweep",
            "ts": round(s.start * _US, 3), "dur": round(s.dur * _US, 3),
            "pid": pids[s.track], "tid": tids[s.phase or "main"],
            "args": dict(s.meta),
        })
    return events


def timeline_to_events(tl: Timeline, *, label: str = "simulated run",
                       pid: int = 1000) -> List[Dict[str, Any]]:
    """A simulated `Timeline` as one process (``pid``) with a thread per
    resource; each op is a complete slice over its *service* interval
    (start -> start+dur; the propagation lag gates dependents but
    occupies no queue, so it is reported in args, not drawn). Simulated
    seconds are rendered as microseconds, so the ruler reads 1:1 in
    simulated time. Zero-duration barrier ops on the dummy resource are
    skipped — they carry no time."""
    events: List[Dict[str, Any]] = [_meta_event("process_name", pid, label)]
    for r in range(tl.n_resources):
        events.append(_meta_event("thread_name", pid, tl.resource_name(r),
                                  tid=r + 1))
    for i in range(tl.n_ops):
        dur = float(tl.dur[i])
        if dur <= 0.0:
            continue
        c = int(tl.cls[i])
        events.append({
            "name": CLASS_NAMES[c] if c < len(CLASS_NAMES) else f"cls{c}",
            "ph": "X", "cat": "sim",
            "ts": round(float(tl.start[i]) * _US, 3),
            "dur": round(dur * _US, 3),
            "pid": pid, "tid": int(tl.res[i]) + 1,
            "args": {"op": i, "lag_s": float(tl.lag[i])},
        })
    return events


# -- metrics snapshot --------------------------------------------------------------

def stats_snapshot(stats, prefix: str = "") -> Dict[str, Union[int, float]]:
    """Flatten one counters dataclass: int/float fields keep their name,
    dict-valued fields (per-device / per-worker rollups) flatten to
    ``<field>.<key>``. Driven by `dataclasses.fields`, so a counter
    added tomorrow appears here without an edit (the same contract the
    hardened ``reset()`` methods follow)."""
    out: Dict[str, Union[int, float]] = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, dict):
            for k, n in sorted(v.items()):
                out[f"{prefix}{f.name}.{k}"] = n
        elif isinstance(v, (int, float)):
            out[f"{prefix}{f.name}"] = v
    return out


def metrics_snapshot(session=None, *,
                     extra: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Union[int, float]]:
    """One flat dict over every counter the stack maintains: the
    session's engine `CacheStats` (``engine.*`` — bucket/row/stack
    caches, device + worker placement, kernel dispatch, fault
    fallbacks), its `CompileCacheStats` (``compile.*`` — DAG cache,
    grid dedup, disk persistence, per-worker compiles), and the
    process-wide `compile_workflow` ground-truth counter. ``session``
    defaults to the process default session; ``extra`` entries are
    merged last (the harness injects e.g. timestamps)."""
    from ..core.compile import compile_count          # deferred: keep obs
    if session is None:                               # core-free at import
        from ..core.sweep.session import default_session
        session = default_session()
    out: Dict[str, Union[int, float]] = {}
    out.update(stats_snapshot(session.stats, "engine."))
    out.update(stats_snapshot(session.compile_stats, "compile."))
    out["compile_count"] = compile_count()
    if extra:
        out.update(extra)
    return out


# -- file output -------------------------------------------------------------------

def write_trace(path: Union[str, Path],
                events: Sequence[Dict[str, Any]], *,
                metrics: Optional[Dict[str, Any]] = None,
                meta: Optional[Dict[str, Any]] = None) -> Path:
    """Write events (any mix of span + timeline renders) as a
    Perfetto-loadable JSON object; the metrics snapshot and free-form
    metadata ride in ``otherData``. Returns the written path."""
    doc: Dict[str, Any] = {
        "traceEvents": list(events),
        "displayTimeUnit": "ms",
        "otherData": dict(meta or {}),
    }
    if metrics is not None:
        doc["otherData"]["metrics"] = metrics
    path = Path(path)
    path.write_text(json.dumps(doc, indent=1, sort_keys=False,
                               default=_json_default))
    return path


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")
