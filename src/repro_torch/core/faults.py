"""Fault & straggler scenarios: a seeded, fingerprintable sweep axis.

The paper's predictor models a *healthy* cluster, so a configuration
sweep can never credit replication for what it actually buys —
availability under node loss (the cross-layer companion paper, arXiv
1301.6195, motivates per-file replication hints exactly this way). This
module adds the missing axis: a `FaultScenario` describes node deaths,
degraded disks and client stragglers, rides inside `StorageConfig`
(composed into its fingerprint, so every cache layer — DAG compile
cache, per-bucket callable LRU — distinguishes scenarios
for free), and is honored identically by the compiler/placement layer,
the PyTorch simulators, and the DES reference path.

Scenario components are **rank-based**, not host-id-based: a
`NodeFailure(node=1)` kills the *second storage node* of whatever
config it is paired with, so one scenario sweeps cleanly across
partitions with different host layouts (`grid(faults=...)` skips
candidates too small to host the scenario).

Death semantics are *structural*: the compiler resolves placement task
by task, so a failure triggers relative to workflow progress
(``after_tasks`` placements, or the completion of a named stage) rather
than at a wall-clock instant — the compiled DAG stays static-shaped and
the fault grid still rides the batched simulator. A read whose chunk has no
surviving replica (and a write with no live storage node) compiles to a
*dead op* whose simulated duration is `DEAD_TIME`; any dead op drives
the run's makespan past `FAILED_THRESHOLD` and `RunReport.failed` is
set — failure is a run-level verdict, not a per-task one.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import numpy as np

# Simulated seconds charged to an unservable op (dead node, no surviving
# replica). Finite on purpose: jnp.inf would collide with the exact-mode
# frontier sentinel (finfo.max) and poison min-ready ordering, and NaNs
# from inf*0 would leak into the scan body. 1e30 dominates any real
# makespan by >20 orders of magnitude while keeping every comparison
# and sum well-ordered in f64.
DEAD_TIME = 1e30

# A run whose makespan crosses this is failed (some op was unservable).
FAILED_THRESHOLD = 1e29


def failed(makespan: float) -> bool:
    """Run-level failure verdict for a simulated makespan."""
    return bool(makespan >= FAILED_THRESHOLD)


@dataclass(frozen=True)
class NodeFailure:
    """Storage node ``node`` (rank into ``storage_hosts``) dies.

    Trigger: ``after_tasks=k`` — the node survives the first k task
    placements; ``after_stage=S`` — it survives until the last task
    labeled stage S has been placed; both None — dead from the start
    (before preloaded files are placed), i.e. the cluster is simply
    smaller than configured.
    """

    node: int
    after_stage: Optional[str] = None
    after_tasks: Optional[int] = None

    def __post_init__(self):
        if self.node < 0:
            raise ValueError(f"storage rank must be >= 0, got {self.node}")
        if self.after_stage is not None and self.after_tasks is not None:
            raise ValueError("NodeFailure takes after_stage OR after_tasks, not both")
        if self.after_tasks is not None and self.after_tasks < 0:
            raise ValueError(f"after_tasks must be >= 0, got {self.after_tasks}")


@dataclass(frozen=True)
class DiskDegradation:
    """Storage node ``node`` serves ``factor``x slower (service-time
    multiplier on its storage service — the §2.5 mu_sm queue only; its
    NIC queues are unaffected)."""

    node: int
    factor: float

    def __post_init__(self):
        if self.node < 0:
            raise ValueError(f"storage rank must be >= 0, got {self.node}")
        if not self.factor >= 1.0:
            raise ValueError(f"degradation factor must be >= 1, got {self.factor}")


@dataclass(frozen=True)
class Straggler:
    """Client rank ``rank`` computes ``factor``x slower (multiplier on
    its CPU service; network paths are unaffected)."""

    rank: int
    factor: float

    def __post_init__(self):
        if self.rank < 0:
            raise ValueError(f"client rank must be >= 0, got {self.rank}")
        if not self.factor >= 1.0:
            raise ValueError(f"straggler factor must be >= 1, got {self.factor}")


def _canon(components, key):
    """Drop no-op entries, sort canonically, freeze to a tuple."""
    live = tuple(sorted((c for c in components
                         if getattr(c, "factor", None) != 1.0), key=key))
    return live


@dataclass(frozen=True)
class FaultScenario:
    """One injectable failure pattern; hashable, picklable, seedable.

    Normalized on construction: factor-1.0 entries are dropped and
    components are canonically sorted, so two scenarios describing the
    same physics compare (and fingerprint) equal. A scenario that
    normalizes to *nothing* is `healthy` — `StorageConfig` collapses it
    to ``faults=None``, which is why the zero-fault path is bit-identical
    to not passing a scenario at all. ``name`` is cosmetic (excluded
    from equality and fingerprint), like `Workflow.name`.
    """

    failures: Tuple[NodeFailure, ...] = ()
    degraded: Tuple[DiskDegradation, ...] = ()
    stragglers: Tuple[Straggler, ...] = ()
    name: str = field(default="", compare=False)

    def __post_init__(self):
        object.__setattr__(self, "failures", tuple(sorted(
            self.failures, key=lambda f: (f.node, f.after_stage or "",
                                          -1 if f.after_tasks is None else f.after_tasks))))
        object.__setattr__(self, "degraded",
                           _canon(self.degraded, key=lambda d: (d.node, d.factor)))
        object.__setattr__(self, "stragglers",
                           _canon(self.stragglers, key=lambda s: (s.rank, s.factor)))
        seen_deg = {d.node for d in self.degraded}
        if len(seen_deg) != len(self.degraded):
            raise ValueError("duplicate DiskDegradation node ranks")
        seen_str = {s.rank for s in self.stragglers}
        if len(seen_str) != len(self.stragglers):
            raise ValueError("duplicate Straggler client ranks")

    @property
    def healthy(self) -> bool:
        return not (self.failures or self.degraded or self.stragglers)

    @property
    def max_storage_rank(self) -> int:
        """Largest storage rank referenced (-1 when none) — `grid()` skips
        partitions with fewer storage nodes than the scenario needs."""
        ranks = [f.node for f in self.failures] + [d.node for d in self.degraded]
        return max(ranks) if ranks else -1

    @property
    def max_client_rank(self) -> int:
        ranks = [s.rank for s in self.stragglers]
        return max(ranks) if ranks else -1

    def fingerprint(self) -> str:
        """Stable content digest (repr of the normalized components —
        deterministic across processes, like `types._fingerprint`)."""
        h = hashlib.blake2b(digest_size=16)
        for part in (self.failures, self.degraded, self.stragglers):
            h.update(repr(part).encode())
            h.update(b"\x00")
        return h.hexdigest()


# --- constructors -----------------------------------------------------------------

def seeded_scenario(seed: int, *, n_storage: int, n_clients: int = 0,
                    kill: int = 0, degrade: int = 0, straggle: int = 0,
                    degrade_range: Tuple[float, float] = (4.0, 16.0),
                    straggle_range: Tuple[float, float] = (2.0, 8.0),
                    after_tasks: Optional[int] = None,
                    name: Optional[str] = None) -> FaultScenario:
    """Deterministic scenario generator: pick ``kill`` dead nodes,
    ``degrade`` degraded disks and ``straggle`` slow clients from a
    seeded RNG. Node/client ranks are drawn below ``n_storage`` /
    ``n_clients`` without replacement (dead nodes are never also
    degraded — a dead disk's speed is moot)."""
    rng = np.random.default_rng(seed)
    if kill + degrade > n_storage:
        raise ValueError(f"kill={kill} + degrade={degrade} exceeds "
                         f"n_storage={n_storage}")
    if straggle > n_clients:
        raise ValueError(f"straggle={straggle} exceeds n_clients={n_clients}")
    nodes = rng.permutation(n_storage)[:kill + degrade]
    failures = tuple(NodeFailure(int(n), after_tasks=after_tasks)
                     for n in nodes[:kill])
    degraded = tuple(
        DiskDegradation(int(n), float(rng.uniform(*degrade_range)))
        for n in nodes[kill:])
    stragglers = tuple(
        Straggler(int(r), float(rng.uniform(*straggle_range)))
        for r in rng.permutation(n_clients)[:straggle])
    return FaultScenario(failures=failures, degraded=degraded,
                         stragglers=stragglers,
                         name=name or f"seed{seed}")


def from_pod_health(health, *, after_stage: Optional[str] = None,
                    after_tasks: Optional[int] = None,
                    extra_nodes: Sequence[int] = (),
                    name: str = "pods") -> FaultScenario:
    """Build a scenario from a `launch.elastic.PodHealth`-like object
    (anything with an ``alive`` list): dead pod i maps to storage rank
    i, plus any explicitly ``extra_nodes`` (e.g. the storage nodes a
    checkpoint restore must read around). Duck-typed so `repro.core`
    never imports the launch layer."""
    dead = {p for p, ok in enumerate(health.alive) if not ok}
    dead.update(int(n) for n in extra_nodes)
    return FaultScenario(
        failures=tuple(NodeFailure(n, after_stage=after_stage,
                                   after_tasks=after_tasks)
                       for n in sorted(dead)),
        name=name)


def parse_faults(spec: str) -> Optional[FaultScenario]:
    """Parse an advisor-CLI fault spec into a scenario.

    Comma-separated tokens:
      ``kill=NODE``          storage rank NODE dead from the start
      ``kill=NODE@K``        ... after K task placements
      ``disk=NODE:FACTOR``   degraded disk (service x FACTOR)
      ``slow=RANK:FACTOR``   straggler client (compute x FACTOR)

    e.g. ``--faults disk=1:8,kill=0@4``. An empty spec returns None.
    """
    spec = spec.strip()
    if not spec:
        return None
    failures, degraded, stragglers = [], [], []
    for token in spec.split(","):
        token = token.strip()
        try:
            kind, _, val = token.partition("=")
            if kind == "kill":
                node, _, after = val.partition("@")
                failures.append(NodeFailure(
                    int(node), after_tasks=int(after) if after else None))
            elif kind == "disk":
                node, _, factor = val.partition(":")
                degraded.append(DiskDegradation(int(node), float(factor)))
            elif kind == "slow":
                rank, _, factor = val.partition(":")
                stragglers.append(Straggler(int(rank), float(factor)))
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"bad fault token {token!r} (want kill=N[@K], disk=N:F or "
                f"slow=R:F): {e}") from e
    return FaultScenario(failures=tuple(failures), degraded=tuple(degraded),
                         stragglers=tuple(stragglers), name=spec)
