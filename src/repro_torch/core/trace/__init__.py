"""Workflow trace front-end: ingestion + synthetic generation.

The scenario-diversity layer (docs/workloads.md): real task-level DAGs
(WfCommons-style JSON, Pegasus-DAX-like XML) and seeded synthetic
families both normalize into the `TraceWorkflow` IR, and one compilation
path (`to_workflow`) turns that into the predictor's `Workflow` — stage
extraction by topological leveling, optional client-rank assignment, and
per-file placement-hint mapping.

    ir        — TraceTask / TraceWorkflow + to_workflow
    wfcommons — WfCommons-style JSON reader
    dax       — minimal Pegasus-DAX XML reader
    generate  — GenSpec families, deterministic under a seed

`load_trace` dispatches on file extension (.json vs .dax/.xml).
Everything here is host-side Python (stdlib and NumPy): the device
work starts at `compile_workflow`'s consumers.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

from . import dax, generate, wfcommons
from .generate import FAMILIES, GenSpec, generate_family
from .ir import TraceError, TraceTask, TraceWorkflow, to_workflow

generate_workflow = generate.generate


def load_trace(path: Union[str, Path], *,
               name: Optional[str] = None) -> TraceWorkflow:
    """Read a trace file, dispatching on extension: ``.json`` ->
    WfCommons-style reader, ``.dax``/``.xml`` -> DAX reader."""
    p = Path(path)
    ext = p.suffix.lower()
    if ext == ".json":
        return wfcommons.load(p, name=name)
    if ext in (".dax", ".xml"):
        return dax.load(p, name=name)
    raise TraceError(f"unknown trace extension {ext!r} for {p} "
                     f"(expected .json, .dax or .xml)")


__all__ = [
    "TraceError", "TraceTask", "TraceWorkflow", "to_workflow",
    "GenSpec", "FAMILIES", "generate_workflow", "generate_family",
    "load_trace", "wfcommons", "dax", "generate",
]
