"""WfCommons-style JSON trace reader.

Accepts the common shapes of the WfCommons / wfformat task archives
(https://wfcommons.org): a top-level ``workflow`` object whose ``tasks``
list carries per-task ``files`` (with ``link: input|output`` and a byte
size), plus optional ``parents``/``children`` edge lists and runtimes.
Both the classic embedded-files layout and the newer split
``specification``/``execution`` layout are understood; unknown fields
are ignored rather than rejected — archives vary wildly in decoration.

Everything normalizes into the backend-neutral `TraceWorkflow` IR
(`ir.py`); no simulation — pure parsing.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from ..types import FileAttr, Placement
from .ir import TraceError, TraceTask, TraceWorkflow

_IN_LINKS = {"input", "in"}
_OUT_LINKS = {"output", "out"}


def _file_size(f: dict) -> Optional[int]:
    for k in ("sizeInBytes", "size"):
        if k in f and f[k] is not None:
            return int(f[k])
    return None


def _ident(d: dict, *keys) -> Optional[str]:
    """First present key, None-aware: the integer id 0 is a valid
    identifier and must not be skipped as falsy."""
    for k in keys:
        if d.get(k) is not None:
            return str(d[k])
    return None


def _file_name(f: dict) -> str:
    name = _ident(f, "id", "name")
    if name is None:
        raise TraceError(f"file entry without a name: {f!r}")
    return name


def _runtime(t: dict) -> Optional[float]:
    """The entry's runtime, or None when it carries no runtime key (an
    execution entry listing only ids/machines must not zero the
    specification's runtime)."""
    for k in ("runtimeInSeconds", "runtime"):
        if k in t and t[k] is not None:
            return float(t[k])
    return None


_HINT_PLACEMENTS = {p.value: p for p in Placement}


def _parse_hint(h: dict) -> FileAttr:
    """Per-file placement hints, the [11, 8]-style workload annotations:
    ``{"placement": "local"|"collocate"|..., "replication": r,
    "group": name}``."""
    pl = h.get("placement")
    if pl is not None and pl not in _HINT_PLACEMENTS:
        raise TraceError(f"unknown placement hint {pl!r} "
                         f"(expected one of {sorted(_HINT_PLACEMENTS)})")
    return FileAttr(placement=_HINT_PLACEMENTS[pl] if pl else None,
                    replication=int(h["replication"]) if h.get("replication")
                    else None,
                    collocate_group=h.get("group"))


def loads(text: str, *, name: Optional[str] = None) -> TraceWorkflow:
    """Parse a WfCommons-style JSON document into a `TraceWorkflow`."""
    doc = json.loads(text)
    wf = doc.get("workflow", doc)
    spec = wf.get("specification", wf)
    raw_tasks = spec.get("tasks")
    if not isinstance(raw_tasks, list) or not raw_tasks:
        raise TraceError("no workflow.tasks list in trace JSON")

    # newer split layout: runtimes live under workflow.execution.tasks
    exec_rt: Dict[str, float] = {}
    for et in (wf.get("execution", {}) or {}).get("tasks", []) or []:
        tid = _ident(et, "id", "name")
        rt_val = _runtime(et)
        if tid is not None and rt_val is not None:
            exec_rt[tid] = rt_val

    # split layout: files (with sizes) may live in a top-level spec.files
    # list and be referenced from tasks via inputFiles/outputFiles ids
    sizes: Dict[str, int] = {}
    for f in spec.get("files", []) or []:
        sz = _file_size(f)
        if sz is not None:
            sizes[_file_name(f)] = sz

    tasks: List[TraceTask] = []
    edges: List[Tuple[str, str]] = []
    hints: Dict[str, FileAttr] = {}
    for rt in raw_tasks:
        tid = _ident(rt, "id", "name")
        if tid is None:
            raise TraceError(f"task without id/name: {rt!r}")
        ins: List[str] = []
        outs: List[str] = []
        for f in rt.get("files", []) or []:
            fname = _file_name(f)
            link = str(f.get("link", "")).lower()
            if link in _IN_LINKS:
                ins.append(fname)
            elif link in _OUT_LINKS:
                outs.append(fname)
            else:
                raise TraceError(f"task {tid!r}: file {fname!r} has "
                                 f"unknown link {f.get('link')!r}")
            sz = _file_size(f)
            if sz is not None:
                sizes[fname] = sz
            if f.get("hint"):
                hints[fname] = _parse_hint(f["hint"])
        ins += [str(x) for x in rt.get("inputFiles", []) or []]
        outs += [str(x) for x in rt.get("outputFiles", []) or []]
        for p in rt.get("parents", []) or []:
            edges.append((str(p), tid))
        for c in rt.get("children", []) or []:
            edges.append((tid, str(c)))
        spec_rt = _runtime(rt)
        tasks.append(TraceTask(
            tid=tid, category=str(rt.get("category") or ""),
            runtime=exec_rt.get(tid, spec_rt if spec_rt is not None else 0.0),
            inputs=tuple(dict.fromkeys(ins)),
            outputs=tuple(dict.fromkeys(outs))))

    tw = TraceWorkflow(
        name=name or str(doc.get("name") or wf.get("name") or "trace"),
        tasks=tasks, file_sizes=sizes,
        edges=list(dict.fromkeys(edges)), hints=hints)
    tw.validate()
    return tw


def load(path: Union[str, Path], *, name: Optional[str] = None) -> TraceWorkflow:
    """Read a WfCommons-style JSON trace file."""
    p = Path(path)
    return loads(p.read_text(), name=name or p.stem)
