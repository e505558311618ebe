"""Request/response types for the advisor service (docs/serving.md).

An `AdvisorRequest` is one client's question — "which of these storage
configurations is best for my workflow?" — exactly the question one
direct `sweep.search.explore` call answers. The server's contract is
bit-identity with that call: whatever batching, coalescing, or caching
happens between admission and response, the evaluations a client gets
back are element-wise identical to running `explore` itself.

Identity is structural, riding the same fingerprint machinery the
compile cache keys on:

* ``query_key`` = ``(Workflow.fingerprint(), grid_fingerprint(...))`` —
  two requests with equal keys ask the *same question* and may share one
  sweep (the coalescer's bucket key) and one cached answer;
* ``service_digest`` tags cached answers with the system seed they were
  computed under (the `SysIdReport`/`CompileCache` invalidation pattern:
  a re-identified system, or a changed compiler, silently invalidates
  every stale entry instead of serving predictions for dead hardware).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.sweep.compilecache import compiler_digest
from ..core.sweep.search import Candidate, Evaluation
from ..core.types import ServiceTimes, Workflow


class DeadlineExceeded(Exception):
    """The request's deadline (``timeout_s`` past submit) expired before
    the server dispatched it. The deadline clock starts at *submit* —
    the reference's fixed ``item_timeout_s`` semantics — so queue wait
    counts against the budget."""

    def __init__(self, waited_s: float, timeout_s: float):
        super().__init__(f"request deadline expired: waited {waited_s:.3f}s "
                         f"of a {timeout_s:.3f}s budget")
        self.waited_s = waited_s
        self.timeout_s = timeout_s


class ServerClosed(Exception):
    """The server shut down before (or while) handling the request."""


def service_digest(st: ServiceTimes) -> str:
    """Content digest of the model seed a cached answer was computed
    under, salted with `compiler_digest()`: re-identified service times
    AND compiler/format changes both invalidate (the same two-part
    pattern `SysIdReport.load` + the disk `CompileCache` enforce)."""
    blob = json.dumps({"st": dataclasses.asdict(st),
                       "compiler": compiler_digest()}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _candidate_pod(c: Candidate) -> list:
    return [c.n_nodes, c.n_app, c.n_storage, c.chunk_size, c.stripe_width,
            c.replication, str(c.placement.value),
            c.faults.fingerprint() if c.faults is not None else ""]


def grid_fingerprint(candidates: Sequence[Candidate], *, verify_top_k: int,
                     objective: str, locality_aware: bool) -> str:
    """Structural digest of everything besides the workflow that shapes
    an `explore` answer: the candidate grid (order included — it breaks
    ties in the sorted output) plus the search knobs."""
    blob = json.dumps({"cands": [_candidate_pod(c) for c in candidates],
                       "verify_top_k": verify_top_k, "objective": objective,
                       "locality_aware": locality_aware}, sort_keys=True)
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


# (workflow fingerprint, grid fingerprint): the coalescing bucket and
# the first two thirds of the results-cache key
QueryKey = Tuple[str, str]

@dataclass(frozen=True)
class AdvisorRequest:
    """One advisor query: a workflow against a candidate grid, with the
    `explore` knobs and an optional deadline. ``client`` is a cosmetic
    tag for stats and tracing; it never enters any cache key."""

    workflow: Workflow
    candidates: Tuple[Candidate, ...]
    verify_top_k: int = 5
    objective: str = "makespan"
    locality_aware: bool = True
    timeout_s: Optional[float] = None
    client: str = ""

    def __post_init__(self):
        object.__setattr__(self, "candidates", tuple(self.candidates))
        if not self.candidates:
            raise ValueError("empty candidate grid")
        if self.objective not in ("makespan", "cost"):
            raise ValueError(f"objective must be 'makespan' or 'cost', "
                             f"got {self.objective!r}")

    def query_key(self) -> QueryKey:
        return (self.workflow.fingerprint(),
                grid_fingerprint(self.candidates,
                                 verify_top_k=self.verify_top_k,
                                 objective=self.objective,
                                 locality_aware=self.locality_aware))


@dataclass
class AdvisorResponse:
    """The answer: `explore`'s sorted evaluations, plus how this request
    was served. ``evaluations`` may be shared with coalesced siblings
    and with the results cache — treat it as read-only."""

    evaluations: List[Evaluation]
    cached: bool = False          # served from the results cache
    group_size: int = 1           # requests this sweep answered at once
    latency_s: float = 0.0        # submit -> response wall clock

    @property
    def best(self) -> Evaluation:
        return self.evaluations[0]

    @property
    def makespans(self) -> np.ndarray:
        """Makespans in ranked order (the bit-identity comparand)."""
        return np.asarray([e.makespan for e in self.evaluations])
