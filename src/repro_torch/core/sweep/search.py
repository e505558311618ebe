"""Configuration-space exploration (§1, §3.2): the provisioning /
partitioning / configuration search the predictor exists to accelerate.

The decision space has three axes (paper, "The Problem"):
    provisioning  — total number of nodes,
    partitioning  — app nodes vs storage nodes,
    configuration — stripe width, replication, chunk size, placement.

Workflow: grid -> batched scan-mode sweep (bucketed, compile-cached, see
`engine.SweepEngine`) -> shortlist -> batched exact-mode verification.
Every exact-verification pass is ONE `SweepRun.simulate(..., exact=True)`
call over the shortlist, not one Python `ref_sim` run per candidate.
Multi-objective output: makespan, allocation cost (node-seconds), and
cost-efficiency, with the Pareto front identified.

Execution is session-driven: every entry point takes ``session=`` (a
`session.SweepSession` whose backend decides inline vs device-sharded
vs multi-process execution — results element-wise identical across all
three, tests/test_torch_backends.py — and whose engine decides on which
device). The pre-session kwargs — ``engine=``, ``compile_cache=``,
``devices=``, ``workers=`` — are deprecated shims that construct an
equivalent session via `SweepSession.from_legacy`; they keep working
and cannot be combined with ``session=``.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from ..faults import FAILED_THRESHOLD, FaultScenario
from ..types import MB, Placement, ServiceTimes, Workflow, partitioned_config
from .backends import SweepRun
from .multiproc import resolve_st
from .compilecache import CompileCache
from .engine import SweepEngine
from .session import SweepSession


@dataclass(frozen=True)
class Candidate:
    """One point of the decision space."""

    n_nodes: int                  # total allocation (incl. manager)
    n_app: int
    n_storage: int
    chunk_size: int
    stripe_width: int = 0
    replication: int = 1
    placement: Placement = Placement.ROUND_ROBIN
    faults: Optional[FaultScenario] = None
                                  # the what-if axis (docs/faults.md): the
                                  # scenario this candidate is judged under

    def to_config(self):
        return partitioned_config(self.n_app, self.n_storage,
                                  stripe_width=self.stripe_width,
                                  replication=self.replication,
                                  chunk_size=self.chunk_size,
                                  placement=self.placement,
                                  faults=self.faults)


@dataclass
class Evaluation:
    candidate: Candidate
    makespan: float
    cost_node_seconds: float      # allocation cost: n_nodes * makespan
    verified: bool = False        # True once re-checked with the exact simulator
    index: int = -1               # position in the swept candidate list; stays
                                  # correct even when the grid holds duplicates
    scan_makespan: float = float("nan")
                                  # the scan-mode estimate; never overwritten by
                                  # verification, so cross-candidate aggregation
                                  # can stay single-backend even when some
                                  # entries were exact-verified
    timeline: Optional[object] = None
                                  # obs.timeline.Timeline for this candidate's
                                  # run, populated only when the caller asked
                                  # (explore(timeline_top_k=...)) — per-op
                                  # schedule, utilization, critical path

    @property
    def cost_efficiency(self) -> float:
        return self.cost_node_seconds  # lower is better per unit of work

    @property
    def failed(self) -> bool:
        """True when the run was unservable under the candidate's fault
        scenario (no surviving replica for some read, or no live storage
        node for some write) — the makespan is the `faults.DEAD_TIME`
        penalty, not a prediction."""
        return self.makespan >= FAILED_THRESHOLD


def grid(n_nodes: Sequence[int], partitions: Optional[Sequence[Tuple[int, int]]] = None,
         chunk_sizes: Sequence[int] = (256 * 1024, 1 * MB, 4 * MB),
         replications: Sequence[int] = (1,),
         stripe_widths: Sequence[int] = (0,),
         placements: Sequence[Placement] = (Placement.ROUND_ROBIN,),
         faults: Sequence[Optional[FaultScenario]] = (None,)) -> List[Candidate]:
    """Enumerate the Scenario-I/II decision grid.

    ``stripe_widths`` sweeps the §3.2 stripe-width knob; 0 means "stripe
    over all storage nodes" (the `StorageConfig` default). Widths larger
    than a partition's storage-node count are skipped for that partition.
    ``faults`` sweeps injected failure scenarios (docs/faults.md) as one
    more axis; scenarios referencing storage/client ranks a partition
    does not have are skipped for that partition, like over-wide stripes.
    """
    if any(sw < 0 for sw in stripe_widths):
        raise ValueError(f"stripe widths must be >= 0, got {tuple(stripe_widths)}")
    # fail here, not as an opaque StorageConfig assert deep inside the sweep
    if any(ck <= 0 for ck in chunk_sizes):
        raise ValueError(f"chunk sizes must be > 0, got {tuple(chunk_sizes)}")
    if any(r < 1 for r in replications):
        raise ValueError(f"replications must be >= 1, got {tuple(replications)}")
    if any(n < 1 for n in n_nodes):
        raise ValueError(f"node counts must be >= 1, got {tuple(n_nodes)}")
    # coerce placement values ("local" and Placement.LOCAL both work);
    # an unknown name raises here instead of an AttributeError deep in
    # the fingerprint/compile path
    placements = tuple(Placement(p) for p in placements)
    out: List[Candidate] = []
    for total in n_nodes:
        parts = partitions or [(a, total - 1 - a) for a in range(1, total - 1)]
        for n_app, n_storage in parts:
            if n_app < 1 or n_storage < 1 or 1 + n_app + n_storage > total:
                continue
            # faults innermost: with the default (None,) axis the emitted
            # order is exactly the pre-fault grid (bit-compat contract)
            for ck, sw, r, pl, f in itertools.product(
                    chunk_sizes, stripe_widths, replications, placements,
                    faults):
                if r > n_storage or sw > n_storage:
                    continue
                if f is not None and not f.healthy and (
                        f.max_storage_rank >= n_storage
                        or f.max_client_rank >= n_app):
                    continue
                out.append(Candidate(n_nodes=total, n_app=n_app, n_storage=n_storage,
                                     chunk_size=ck, stripe_width=sw,
                                     replication=r, placement=pl, faults=f))
    return out


def with_faults(candidates: Sequence[Candidate],
                faults: Sequence[Optional[FaultScenario]]) -> List[Candidate]:
    """Cross an existing candidate list with a fault-scenario axis.

    Every (candidate, scenario) pair becomes one candidate (scenario
    innermost, input order preserved); pairs whose scenario references
    ranks the candidate's partition does not have are skipped, matching
    `grid`'s rule. ``faults=(None,)`` returns an equal copy of the input.
    """
    out: List[Candidate] = []
    for c in candidates:
        for f in faults:
            if f is not None and not f.healthy and (
                    f.max_storage_rank >= c.n_storage
                    or f.max_client_rank >= c.n_app):
                continue
            out.append(dataclasses.replace(c, faults=f))
    return out


def _objective_key(objective: str) -> Callable[[Evaluation], float]:
    return (lambda e: e.makespan) if objective == "makespan" \
        else (lambda e: e.cost_node_seconds)


def _build_evals(candidates: Sequence[Candidate],
                 makespans) -> List[Evaluation]:
    """Scan-phase evaluations, index-aligned with the swept list — the
    single construction every execution backend shares."""
    return [Evaluation(candidate=c, makespan=float(m),
                       cost_node_seconds=float(m) * c.n_nodes, index=i,
                       scan_makespan=float(m))
            for i, (c, m) in enumerate(zip(candidates, makespans))]


def _apply_exact(todo: Sequence[Evaluation], makespans) -> None:
    """Fold exact-mode makespans back into their evaluations."""
    for e, m in zip(todo, makespans):
        e.makespan = float(m)
        e.cost_node_seconds = float(m) * e.candidate.n_nodes
        e.verified = True


def _verify(run: SweepRun, evals: Sequence[Evaluation]) -> None:
    """Exact-mode confirmation: ONE dispatched batch for every
    unverified evaluation (bit-equal to per-candidate
    `ref_sim.simulate`), whatever the backend."""
    todo = [e for e in evals if not e.verified]
    if not todo:
        return
    _apply_exact(todo, run.simulate([e.index for e in todo], exact=True))


def _attach_timelines(sess: SweepSession, evals: Sequence[Evaluation],
                      wfs: Sequence[Workflow], cfgs, st, *,
                      locality_aware: bool, top_k: int) -> None:
    """Populate `Evaluation.timeline` for the ``top_k`` best evaluations:
    one single-run re-simulation each with ``timeline=True``, through the
    session's (warm) compile cache and its engine's kernel dispatch — the
    DAGs were compiled by the sweep, so this costs top_k simulator calls,
    zero compiles."""
    if top_k <= 0:
        return
    st_val = resolve_st(st)
    for e in evals[:top_k]:
        ops = sess.compile_cache.get(wfs[e.index], cfgs[e.index],
                                     locality_aware=locality_aware)
        rep = sess.engine.simulate_one(ops, st_val, exact=e.verified,
                                       timeline=True)
        e.timeline = rep.timeline


def _resolve_session(session: Optional[SweepSession], *,
                     engine: Optional[SweepEngine],
                     compile_cache: Optional[CompileCache],
                     devices, workers: Optional[int]) -> SweepSession:
    """``session=`` or the deprecated kwargs, never both."""
    if session is not None:
        if (engine is not None or compile_cache is not None
                or devices is not None or workers is not None):
            raise ValueError(
                "pass session= or the legacy engine=/compile_cache=/"
                "devices=/workers= kwargs, not both")
        return session
    return SweepSession.from_legacy(engine=engine, compile_cache=compile_cache,
                                    devices=devices, workers=workers)


@dataclass(frozen=True)
class Question:
    """One `explore` question as `explore_batch` takes it: the
    candidates, the workflow each candidate runs, and the two knobs that
    shape its answer besides the sweep's own."""

    workflow_for: Callable[[Candidate], Workflow]
    candidates: Sequence[Candidate]
    verify_top_k: int = 5
    objective: str = "makespan"


def _sweep_questions(sess: SweepSession, questions: Sequence[Question],
                     st: ServiceTimes, *, locality_aware: bool,
                     compile_workers: Optional[int] = None):
    """The one sweep behind `explore`, `explore_batch` and
    `explore_many`: every question's (workflow, config) pairs,
    concatenated, go through ONE `prepare` and ONE scan-mode
    `simulate` (rows of one shape bucket share a launch, whichever
    question they came from); each question's evaluations are sorted by
    its own objective, and every question's shortlist is verified in ONE
    exact-mode batch. An evaluation's ``index`` is its position in the
    concatenated list. Returns the answers, one list a question, and the
    run's workflows and configs."""
    cands = [c for q in questions for c in q.candidates]
    wfs = [q.workflow_for(c) for q in questions for c in q.candidates]
    cfgs = [c.to_config() for c in cands]
    run = sess.prepare(wfs, cfgs, st=st, locality_aware=locality_aware,
                       compile_workers=compile_workers)
    evals = _build_evals(cands, run.simulate())
    answers, at = [], 0
    for q in questions:
        answers.append(evals[at:at + len(q.candidates)])
        at += len(q.candidates)
    keys = [_objective_key(q.objective) for q in questions]
    for a, key in zip(answers, keys):
        a.sort(key=key)
    _verify(run, [e for a, q in zip(answers, questions)
                  for e in a[:q.verify_top_k]])
    for a, key in zip(answers, keys):
        a.sort(key=key)
    return answers, wfs, cfgs


def explore(workflow_for: Callable[[Candidate], Workflow],
            candidates: Sequence[Candidate], st: ServiceTimes, *,
            locality_aware: bool = True, verify_top_k: int = 5,
            objective: str = "makespan",
            timeline_top_k: int = 0,
            faults: Optional[Sequence[Optional[FaultScenario]]] = None,
            session: Optional[SweepSession] = None,
            engine: Optional[SweepEngine] = None,
            compile_cache: Optional[CompileCache] = None,
            compile_workers: Optional[int] = None,
            devices=None, workers: Optional[int] = None) -> List[Evaluation]:
    """Evaluate every candidate with the batched simulator, then verify
    the best `verify_top_k` with one batched exact-mode call. Returns
    evaluations sorted by the objective.

    ``faults`` crosses the candidate list with a fault-scenario axis
    (`with_faults`) before sweeping — include ``None`` in the sequence to
    keep the healthy baseline in the same ranking; omit the kwarg for
    the byte-identical pre-fault behaviour.

    ``timeline_top_k`` > 0 attaches an `obs.timeline.Timeline` (per-op
    schedule + utilization + critical path) to that many of the
    best-ranked evaluations — one extra single-run simulation each
    against the already-warm compile cache, on the session's device.

    ``session`` supplies the execution state, backend and device
    (inline / device-sharded / multi-process — results bit-identical
    across all three, and with the compile cache on or off).
    ``compile_workers`` > 1 compiles cold structural classes on a
    thread pool (inline backends only; worker processes compile their
    own classes).

    Deprecated: ``engine=``/``compile_cache=``/``devices=``/``workers=``
    construct an equivalent session on the default session's shared
    state (`SweepSession.from_legacy`); prefer ``session=``.
    """
    if faults is not None:
        candidates = with_faults(candidates, faults)
    sess = _resolve_session(session, engine=engine,
                            compile_cache=compile_cache,
                            devices=devices, workers=workers)
    (evals,), wfs, cfgs = _sweep_questions(
        sess, [Question(workflow_for, candidates, verify_top_k, objective)],
        st, locality_aware=locality_aware, compile_workers=compile_workers)
    _attach_timelines(sess, evals, wfs, cfgs, st,
                      locality_aware=locality_aware, top_k=timeline_top_k)
    return evals


def explore_batch(questions: Sequence[Question], st: ServiceTimes, *,
                  locality_aware: bool, session: SweepSession
                  ) -> List[List[Evaluation]]:
    """Answer several `explore` questions in one sweep: one `prepare`,
    one scan-mode `simulate` and one exact-mode verification batch for
    all of them, so the rows of different questions that fall in one
    shape bucket run in one launch.

    Returns one evaluation list a question, each equal, field by field,
    to what ``explore(q.workflow_for, q.candidates, st,
    verify_top_k=q.verify_top_k, objective=q.objective,
    locality_aware=locality_aware, session=session)`` returns for that
    question alone: a row's makespan depends on its DAG and service
    times only, never on its batch-mates, and `Evaluation.index` is the
    position in the question's own candidate list. ``locality_aware``
    changes the compile, so it is one for the whole batch."""
    answers, _, _ = _sweep_questions(session, questions, st,
                                     locality_aware=locality_aware)
    at = 0
    for q, a in zip(questions, answers):
        for e in a:
            e.index -= at
        at += len(q.candidates)
    return answers


def explore_many(workflows: Sequence, candidates: Sequence[Candidate],
                 st: ServiceTimes, *, locality_aware: bool = True,
                 verify_top_k: int = 5, objective: str = "makespan",
                 faults: Optional[Sequence[Optional[FaultScenario]]] = None,
                 session: Optional[SweepSession] = None,
                 engine: Optional[SweepEngine] = None,
                 compile_cache: Optional[CompileCache] = None,
                 compile_workers: Optional[int] = None,
                 devices=None,
                 workers: Optional[int] = None) -> List[List[Evaluation]]:
    """Workflow-axis sweep: evaluate a *set* of workflows against one
    candidate grid in a single batched run.

    ``workflows`` elements are either `Workflow`s (trace-ingested or
    generated DAGs, candidate-independent) or callables
    ``candidate -> Workflow`` (functions that depend on the partition,
    like the BLAST scenario). The full ``len(workflows) x
    len(candidates)`` product goes through ONE `compile_grid` call —
    structurally-equal siblings (recurring DAGs in a generated family or
    a trace archive) dedup into one compiled `MicroOps` — then ONE
    scan-mode `simulate_batch`, and the per-workflow shortlists are
    verified with ONE exact-mode batch for the whole set.

    Returns one evaluation list per workflow (aligned with
    ``workflows``), each sorted by the objective; `Evaluation.index` is
    the position in the flattened product (workflow-major). The
    session's backend decides where the product sweep runs; a
    multi-process backend partitions its structural-class groups across
    host processes (see `multiproc`). ``faults`` crosses the candidate
    grid with a fault-scenario axis (`with_faults`) before the product
    is formed."""
    if faults is not None:
        candidates = with_faults(candidates, faults)
    sess = _resolve_session(session, engine=engine,
                            compile_cache=compile_cache,
                            devices=devices, workers=workers)
    questions = [Question(w if callable(w) else (lambda c, w=w: w),
                          candidates, verify_top_k, objective)
                 for w in workflows]
    answers, _, _ = _sweep_questions(sess, questions, st,
                                     locality_aware=locality_aware,
                                     compile_workers=compile_workers)
    return answers


def pareto_front(evals: Iterable[Evaluation]) -> List[Evaluation]:
    """Non-dominated points in (makespan, cost) — the Scenario-II answer."""
    pts = sorted(evals, key=lambda e: (e.makespan, e.cost_node_seconds))
    front: List[Evaluation] = []
    best_cost = float("inf")
    for e in pts:
        if e.cost_node_seconds < best_cost:
            front.append(e)
            best_cost = e.cost_node_seconds
    return front


def successive_halving(workflow_for: Callable[[Candidate], Workflow],
                       candidates: Sequence[Candidate], st: ServiceTimes, *,
                       locality_aware: bool = True, eta: int = 3,
                       objective: str = "makespan",
                       faults: Optional[Sequence[Optional[FaultScenario]]] = None,
                       session: Optional[SweepSession] = None,
                       engine: Optional[SweepEngine] = None,
                       compile_cache: Optional[CompileCache] = None,
                       compile_workers: Optional[int] = None,
                       devices=None,
                       workers: Optional[int] = None) -> List[Evaluation]:
    """Beyond-paper search: rank the full grid with the cheap scan-mode
    simulator, keep the top 1/eta, re-rank those with the exact simulator
    (one batched call per halving round), repeat. Converges to
    exact-verified winners with far fewer exact sims than exhaustive
    verification. Every round — scan and exact alike — runs through the
    session's backend on the same prepared run, so bucket callables,
    DAGs, device batches and worker pools stay warm across rounds. ``faults`` crosses the
    grid with a fault-scenario axis before round one, like `explore`.
    Legacy kwargs as in `explore` (deprecated)."""
    if faults is not None:
        candidates = with_faults(candidates, faults)
    sess = _resolve_session(session, engine=engine,
                            compile_cache=compile_cache,
                            devices=devices, workers=workers)
    key = _objective_key(objective)
    wfs = [workflow_for(c) for c in candidates]
    cfgs = [c.to_config() for c in candidates]
    run = sess.prepare(wfs, cfgs, st=st, locality_aware=locality_aware,
                       compile_workers=compile_workers)
    evals = _build_evals(candidates, run.simulate())
    evals.sort(key=key)
    while len(evals) > eta:
        keep = max(len(evals) // eta, 1)
        evals = evals[:keep]
        _verify(run, evals)
        evals.sort(key=key)
        if all(e.verified for e in evals):
            break
    return evals
