"""Simulated-run timelines: the paper's chunk-level model made
inspectable (docs/observability.md).

The simulators already compute a completion time for every micro-op —
`torch_sim` returns the per-op ``end`` array, and start = end − lag −
duration — so a scalar makespan throws information away. A `Timeline`
keeps it: per-op start/end intervals on their FIFO resources, busy-time
/ utilization per resource (storage nodes, client CPUs, NICs, the
manager), and **critical-path extraction**: the chain of ops that
explains the makespan, where every link is either a dependency edge
(the op started the moment a predecessor's data arrived) or a queue
edge (the op started the moment the previous occupant released its
resource). The chain is contiguous from t=0 to the makespan by
construction, so `critical_path_duration()` — the sum of the chain's
segments — equals the reported makespan to float tolerance; extraction
*fails loudly* (ValueError) if no contiguous chain exists, which is the
self-check that the interval arithmetic matches the simulator.

This module is core-free (numpy only): `torch_sim.simulate(...,
timeline=True)` builds instances from its own arrays, and the sweep
layer attaches them to `Evaluation.timeline` — see those call sites for
the glue.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Timeline:
    """Per-op schedule of one simulated run (original op order, no
    padding). ``end`` includes the network propagation lag that delays
    dependents; ``start + dur`` (the *service finish*) is what occupies
    the resource and what the makespan is the max of."""

    start: np.ndarray             # f64[N] service start
    dur: np.ndarray               # f64[N] service duration (fault-adjusted)
    lag: np.ndarray               # f64[N] post-service propagation lag
    end: np.ndarray               # f64[N] start + dur + lag (dependents' gate)
    res: np.ndarray               # i32[N] resource id (FIFO queue) per op
    cls: np.ndarray               # i8[N] service class per op
    deps: np.ndarray              # i32[N, MAXD] predecessor ops (-1 = none)
    makespan: float
    n_resources: int
    resource_names: Optional[Tuple[str, ...]] = None
                                  # cosmetic labels (export.resource_names);
                                  # None -> "res<i>" at export time

    @property
    def n_ops(self) -> int:
        return int(self.res.shape[0])

    @property
    def fin(self) -> np.ndarray:
        """Service-finish times (resource release; excludes lag)."""
        return self.start + self.dur

    # -- per-resource rollups --------------------------------------------------
    def busy_seconds(self) -> np.ndarray:
        """Total service seconds per resource, f64[n_resources]."""
        busy = np.zeros(self.n_resources)
        np.add.at(busy, self.res, self.dur)
        return busy

    def utilization(self) -> np.ndarray:
        """Busy fraction of the makespan per resource (0 for an idle
        resource; a FIFO single-server queue can never exceed 1)."""
        if self.makespan <= 0.0:
            return np.zeros(self.n_resources)
        return self.busy_seconds() / self.makespan

    # -- critical path ---------------------------------------------------------
    def _tol(self) -> float:
        # interval endpoints are f64 sums re-derived by subtraction
        # (start = end - lag - dur), so exact equality is one rounding
        # step too strict; scale the link tolerance with the horizon
        return 1e-9 * max(self.makespan, 1.0) + 1e-12

    def critical_path(self) -> List[int]:
        """Op ids from the chain start (t ~ 0) to the op whose service
        finish IS the makespan. Each consecutive pair is linked by a
        dependency edge (``start[b]`` == a predecessor's ``end``) or a
        queue edge (``start[b]`` == the previous occupant's ``fin`` on
        the same resource). Raises ValueError when no contiguous chain
        exists — the arithmetic self-check described in the module
        docstring. Ties break toward the lowest op id, so extraction is
        deterministic."""
        if self.n_ops == 0:
            return []
        fin = self.fin
        tol = self._tol()
        path = [int(np.argmax(fin))]
        # zero-duration barrier ops make simultaneity common (a whole
        # cluster can share one instant), so the walk tracks visited ops:
        # links never revisit, which bounds the loop and breaks ties
        # among coincident ops without cycling
        visited = {path[0]}
        # per-resource op ids once (ascending, by a stable sort), not an
        # O(N) scan per backward step; the queue-edge search below is
        # vectorised over one resource's ops, since a paper-scale DAG
        # puts tens of thousands of ops on one NIC or storage node
        order = np.argsort(self.res, kind="stable")
        bounds = np.cumsum(np.bincount(self.res, minlength=self.n_resources))
        by_res = np.split(order, bounds[:-1])
        for _ in range(self.n_ops):             # visited can't exceed n_ops
            i = path[-1]
            s = float(self.start[i])
            if s <= tol:
                break                           # reached the t=0 frontier
            pred = -1
            # dependency edge: the dep whose (lagged) end gated this start
            for d in self.deps[i]:
                if d >= 0 and int(d) not in visited \
                        and abs(float(self.end[d]) - s) <= tol:
                    pred = int(d) if pred < 0 else min(pred, int(d))
            if pred < 0:
                # queue edge: previous occupant released the resource at s
                # (the lowest unvisited op id among those that did)
                js = by_res[int(self.res[i])]
                for j in js[np.abs(fin[js] - s) <= tol].tolist():
                    if j not in visited:
                        pred = j
                        break
            if pred < 0:
                raise ValueError(
                    f"critical-path chain break at op {i}: start {s!r} "
                    "matches no predecessor end and no queue release")
            path.append(pred)
            visited.add(pred)
        else:
            raise ValueError("critical-path walk did not terminate")
        path.reverse()
        return path

    def critical_path_duration(self) -> float:
        """The chain's total extent: sum of its segments (each op's
        start-to-handoff interval, plus the final op's service). Equals
        ``fin[last] − start[first]`` — and, because the chain starts at
        t ~ 0 and ends at the makespan op, equals the makespan to float
        tolerance (asserted by tests/test_torch_obs.py and, on the card,
        by chip_smoke.py's ``advisor_path`` phase)."""
        path = self.critical_path()
        if not path:
            return 0.0
        segments = [float(self.start[b] - self.start[a])
                    for a, b in zip(path, path[1:])]
        segments.append(float(self.dur[path[-1]]))
        return float(sum(segments))

    def resource_name(self, r: int) -> str:
        if self.resource_names is not None and r < len(self.resource_names):
            return self.resource_names[r]
        return f"res{r}"
