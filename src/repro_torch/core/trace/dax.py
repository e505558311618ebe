"""Minimal Pegasus-DAX-like XML trace reader.

Understands the subset of the classic Pegasus abstract-DAG format that
carries performance-relevant structure:

    <adag name="...">
      <job id="ID01" name="mProject" runtime="12.5">
        <uses file="in.fits"  link="input"  size="1048576"/>
        <uses file="out.fits" link="output" size="2097152"/>
      </job>
      <child ref="ID02"><parent ref="ID01"/></child>
    </adag>

Namespaced documents (`xmlns=...`) are accepted — tags are matched on
their local name. Everything else (profiles, transformation catalogs,
argument lists) is ignored. Output is the same `TraceWorkflow` IR the
JSON reader produces, so both front-ends share one compilation path.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from .ir import TraceError, TraceTask, TraceWorkflow

_IN_LINKS = {"input", "in"}
_OUT_LINKS = {"output", "out"}


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def loads(text: str, *, name: Optional[str] = None) -> TraceWorkflow:
    """Parse a DAX-like XML document into a `TraceWorkflow`."""
    try:
        root = ET.fromstring(text)
    except ET.ParseError as e:
        raise TraceError(f"malformed DAX XML: {e}") from e

    tasks: List[TraceTask] = []
    sizes: Dict[str, int] = {}
    edges: List[Tuple[str, str]] = []
    for el in root:
        kind = _local(el.tag)
        if kind == "job":
            tid = el.get("id") or el.get("name")
            if not tid:
                raise TraceError("DAX job without id")
            ins: List[str] = []
            outs: List[str] = []
            for u in el:
                if _local(u.tag) != "uses":
                    continue
                fname = u.get("file") or u.get("name")
                if not fname:
                    raise TraceError(f"job {tid!r}: <uses> without a file name")
                link = (u.get("link") or "").lower()
                if link in _IN_LINKS:
                    ins.append(fname)
                elif link in _OUT_LINKS:
                    outs.append(fname)
                else:
                    raise TraceError(f"job {tid!r}: file {fname!r} has "
                                     f"unknown link {u.get('link')!r}")
                if u.get("size") is not None:
                    sizes[fname] = int(u.get("size"))
            tasks.append(TraceTask(
                tid=str(tid), category=str(el.get("name") or ""),
                runtime=float(el.get("runtime") or 0.0),
                inputs=tuple(dict.fromkeys(ins)),
                outputs=tuple(dict.fromkeys(outs))))
        elif kind == "child":
            child = el.get("ref")
            if not child:
                raise TraceError("<child> without ref")
            for p in el:
                if _local(p.tag) == "parent" and p.get("ref"):
                    edges.append((str(p.get("ref")), str(child)))

    if not tasks:
        raise TraceError("no <job> elements in DAX document")
    tw = TraceWorkflow(name=name or str(root.get("name") or "dax"),
                       tasks=tasks, file_sizes=sizes,
                       edges=list(dict.fromkeys(edges)))
    tw.validate()
    return tw


def load(path: Union[str, Path], *, name: Optional[str] = None) -> TraceWorkflow:
    """Read a DAX-like XML trace file."""
    p = Path(path)
    return loads(p.read_text(), name=name or p.stem)
