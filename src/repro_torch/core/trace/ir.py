"""Backend-neutral workflow-trace IR and its compilation to `Workflow`.

The paper evaluates against "synthetic benchmarks mimicking real workflow
applications, and a real application" (§6); the hand-coded builders in
`core/workloads.py` cover the synthetic patterns, and this layer opens
the other half: arbitrary task-level DAGs from real trace archives
(WfCommons / Pegasus-style, the standard substrate for workflow
performance studies) or from the seeded generator (`trace/generate.py`).

`TraceWorkflow` is deliberately front-end-neutral: both the JSON reader
(`wfcommons.py`), the DAX reader (`dax.py`), and the generator emit it,
and one compilation path (`to_workflow`) turns any of them into the
predictor's `Workflow`:

* **stage extraction** — tasks are topologically leveled; a task's stage
  label is its trace category (``mProject``, ``blastall``...) when
  present, else ``level<k>``, so per-stage reporting works on traces
  that never named their stages;
* **client-rank assignment** — ``clients=n`` pins tasks round-robin (in
  level order) onto ranks ``0..n-1``; ``clients=None`` leaves them to
  the compiler's locality-aware / least-loaded scheduler;
* **placement-hint mapping** — per-file `FileAttr` hints (the [11,8]
  per-file policies `Workflow` already models) attach to the producing
  task (or the preloaded entry) of each hinted file;
* **control edges** — trace edges with no data flow (a WfCommons
  parent/child pair sharing no file) are realized as 0-byte control
  files: they cost only the manager round-trips real dependency
  signalling costs (0-size files carry no chunks, §2.5).

Nothing in this module touches a device — trace ingestion and generation
are host-side front-ends; the device work starts after `compile_workflow`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..types import FileAttr, Task, Workflow


class TraceError(ValueError):
    """A trace that cannot be normalized into the predictor's model
    (cyclic deps, a file written twice, a consumed file with no size)."""


@dataclass(frozen=True)
class TraceTask:
    """One task instance of a trace: identity, dataflow, compute time."""

    tid: str                                   # trace-level task id (unique)
    category: str = ""                         # transformation name, if any
    runtime: float = 0.0                       # pure compute seconds
    inputs: Tuple[str, ...] = ()               # file names read
    outputs: Tuple[str, ...] = ()              # file names written


@dataclass
class TraceWorkflow:
    """Normalized trace: tasks + file sizes + explicit control edges.

    ``file_sizes`` must cover every file that moves bytes (readers with
    no producer become preloaded inputs). ``edges`` carries parent->child
    pairs *beyond* the file-implied ones (WfCommons traces list both);
    file-implied dependencies need no entry. ``hints`` maps file name ->
    `FileAttr` placement hints.
    """

    name: str
    tasks: List[TraceTask]
    file_sizes: Dict[str, int] = field(default_factory=dict)
    edges: List[Tuple[str, str]] = field(default_factory=list)
    hints: Dict[str, FileAttr] = field(default_factory=dict)

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    def producers(self) -> Dict[str, str]:
        prod: Dict[str, str] = {}
        for t in self.tasks:
            for f in t.outputs:
                if f in prod:
                    raise TraceError(
                        f"{self.name}: file {f!r} written by both "
                        f"{prod[f]!r} and {t.tid!r}")
                prod[f] = t.tid
        return prod

    def validate(self, prod: Optional[Dict[str, str]] = None) -> None:
        seen = set()
        for t in self.tasks:
            if t.tid in seen:
                raise TraceError(f"{self.name}: duplicate task id {t.tid!r}")
            seen.add(t.tid)
        prod = self.producers() if prod is None else prod
        for t in self.tasks:
            for f in t.inputs:
                if prod.get(f) == t.tid:
                    # an in-place update cannot be expressed in the
                    # single-producer dataflow model; fail here, not as
                    # a KeyError deep inside compile_workflow
                    raise TraceError(
                        f"{self.name}: task {t.tid!r} both reads and "
                        f"writes {f!r} (in-place updates are not "
                        f"representable)")
                if f not in prod and f not in self.file_sizes:
                    raise TraceError(
                        f"{self.name}: task {t.tid!r} reads {f!r}, which has "
                        f"no producer and no recorded size")
        for a, b in self.edges:
            if a not in seen or b not in seen:
                raise TraceError(f"{self.name}: edge ({a!r}, {b!r}) names an "
                                 f"unknown task")

    # -- structure ------------------------------------------------------------
    def parents_of(self, prod: Optional[Dict[str, str]] = None) -> Dict[str, set]:
        """Full dependency map: file-implied plus explicit edges."""
        prod = self.producers() if prod is None else prod
        par: Dict[str, set] = {t.tid: set() for t in self.tasks}
        for t in self.tasks:
            for f in t.inputs:
                p = prod.get(f)
                if p is not None and p != t.tid:
                    par[t.tid].add(p)
        for a, b in self.edges:
            if a != b:
                par[b].add(a)
        return par

    def levels(self, prod: Optional[Dict[str, str]] = None) -> Dict[str, int]:
        """Topological level of every task (longest path from a root).

        The leveling is the trace-side stage extraction: tasks at equal
        depth form one wave of the workflow, the unit per-stage reporting
        and client-rank assignment work in. Raises `TraceError` on
        cycles."""
        par = self.parents_of(prod)
        children: Dict[str, List[str]] = {tid: [] for tid in par}
        indeg = {tid: len(ps) for tid, ps in par.items()}
        for tid, ps in par.items():
            for p in ps:
                children[p].append(tid)
        # Kahn's algorithm in trace order (deterministic for equal levels)
        order = [t.tid for t in self.tasks]
        level = {tid: 0 for tid in indeg}
        queue = [tid for tid in order if indeg[tid] == 0]
        done = 0
        while queue:
            nxt: List[str] = []
            for tid in queue:
                done += 1
                for c in children[tid]:
                    level[c] = max(level[c], level[tid] + 1)
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        nxt.append(c)
            queue = nxt
        if done != len(self.tasks):
            cyc = sorted(tid for tid, d in indeg.items() if d > 0)
            raise TraceError(f"{self.name}: dependency cycle through {cyc[:5]}")
        return level

    def total_bytes(self) -> int:
        return sum(self.file_sizes.get(f, 0)
                   for t in self.tasks for f in t.outputs)


def _ctrl_file(parent: str) -> str:
    return f"__ctrl__{parent}"


def to_workflow(tw: TraceWorkflow, *, clients: Optional[int] = None,
                runtime_scale: float = 1.0) -> Workflow:
    """Compile a `TraceWorkflow` into the predictor's `Workflow`.

    ``clients`` pins tasks round-robin (level-major order) onto client
    ranks ``0..clients-1`` — use the candidate's app-node count in
    sweeps; ``None`` defers to the compiler's scheduler.
    ``runtime_scale`` scales all trace runtimes (traces recorded on
    different hardware than the modeled cluster).
    """
    prod = tw.producers()       # built once; validate/levels reuse it
    tw.validate(prod)
    level = tw.levels(prod)

    # level-major deterministic order: (level, original position)
    pos = {t.tid: i for i, t in enumerate(tw.tasks)}
    ordered = sorted(tw.tasks, key=lambda t: (level[t.tid], pos[t.tid]))

    # control edges: explicit parent->child pairs not already implied by
    # a shared file become 0-byte control-file dependencies
    implied: Dict[str, set] = {t.tid: set() for t in tw.tasks}
    for t in tw.tasks:
        for f in t.inputs:
            p = prod.get(f)
            if p is not None:
                implied[t.tid].add(p)
    ctrl_parents: Dict[str, List[str]] = {}  # child -> [parents], ctrl-only
    ctrl_writers: set = set()                # parents that must emit a ctrl file
    for a, b in tw.edges:
        if a != b and a not in implied[b]:
            ctrl_parents.setdefault(b, []).append(a)
            ctrl_writers.add(a)
            implied[b].add(a)

    tasks: List[Task] = []
    preloaded: Dict[str, Tuple[int, Optional[FileAttr]]] = {}
    consumed = {f for t in tw.tasks for f in t.inputs}
    for f, sz in tw.file_sizes.items():
        # producerless files referenced by a reader become preloaded;
        # unreferenced sizes are metadata noise common in trace archives
        if f not in prod and f in consumed:
            preloaded[f] = (int(sz), tw.hints.get(f))

    for rank, t in enumerate(ordered):
        inputs = list(t.inputs)
        inputs += [_ctrl_file(p) for p in sorted(set(ctrl_parents.get(t.tid, ())))]
        outputs: List[Tuple[str, int]] = []
        for f in t.outputs:
            if f not in tw.file_sizes:
                raise TraceError(
                    f"{tw.name}: output {f!r} of {t.tid!r} has no size")
            outputs.append((f, int(tw.file_sizes[f])))
        if t.tid in ctrl_writers:
            outputs.append((_ctrl_file(t.tid), 0))
        attrs = {f: tw.hints[f] for f, _ in outputs if f in tw.hints}
        stage = t.category or f"level{level[t.tid]}"
        client = None if clients is None else rank % max(int(clients), 1)
        tasks.append(Task(tid=rank, inputs=tuple(inputs),
                          outputs=tuple(outputs),
                          runtime=float(t.runtime) * runtime_scale,
                          client=client, stage=stage, file_attrs=attrs))

    wf = Workflow(tasks=tasks, name=tw.name, preloaded=preloaded)
    wf.validate()
    return wf
