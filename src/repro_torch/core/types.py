"""Core datatypes for the intermediate-storage performance predictor.

These mirror the paper's three inputs (§2.3):
  * the storage-system configuration        -> :class:`StorageConfig`
  * the workload description                -> :class:`Workflow` (+ traces)
  * per-component service times (sysid)     -> :class:`ServiceTimes`
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .faults import FAILED_THRESHOLD, FaultScenario

KB = 1 << 10
MB = 1 << 20
GB = 1 << 30

CTRL_BYTES = 1 * KB  # paper §5: "we model all control messages as having the same size"


def _fingerprint(*parts) -> str:
    """Stable 128-bit content digest of a canonical repr of ``parts``.

    Everything hashed here is built from reprs of primitives, tuples and
    frozen dataclasses, so the digest is deterministic across processes
    (no dependence on PYTHONHASHSEED or object identity)."""
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()


class Placement(str, enum.Enum):
    """Data placement policies (§2.2)."""

    ROUND_ROBIN = "round_robin"  # default: stripe chunks over `stripe_width` nodes
    LOCAL = "local"              # all chunks on the storage node co-located with the writer
    COLLOCATE = "collocate"      # all chunks of a file group on one designated node
    BROADCAST = "broadcast"      # round-robin + eager replication (for one-to-many reads)


@dataclass(frozen=True)
class StorageConfig:
    """System-wide configuration of the intermediate storage deployment.

    ``n_hosts`` machines; host 0 runs the manager. Storage services run on
    hosts ``storage_hosts``; client (application) services on
    ``client_hosts``. The paper's default testbed collocates one storage
    node and one client on each of 19 hosts, manager on the 20th.
    """

    n_hosts: int
    storage_hosts: Tuple[int, ...]
    client_hosts: Tuple[int, ...]
    manager_host: int = 0
    stripe_width: int = 0          # 0 => stripe over all storage nodes
    replication: int = 1
    chunk_size: int = 1 * MB
    placement: Placement = Placement.ROUND_ROBIN
    faults: Optional[FaultScenario] = None   # injected failure pattern
                                             # (None = healthy cluster)

    def __post_init__(self):
        # real ValueErrors, not asserts: `python -O` strips asserts, and
        # grid() already raises ValueError for the same knobs — an invalid
        # config must fail loudly either way (regression: tests/test_faults.py)
        if self.stripe_width == 0:
            object.__setattr__(self, "stripe_width", len(self.storage_hosts))
        if not 1 <= self.stripe_width <= len(self.storage_hosts):
            raise ValueError(
                f"stripe_width {self.stripe_width} out of range for "
                f"{len(self.storage_hosts)} storage nodes")
        if not 1 <= self.replication <= len(self.storage_hosts):
            raise ValueError(
                f"replication {self.replication} out of range for "
                f"{len(self.storage_hosts)} storage nodes")
        if self.chunk_size <= 0:
            raise ValueError(f"chunk_size must be > 0, got {self.chunk_size}")
        if not 0 <= self.manager_host < self.n_hosts:
            raise ValueError(
                f"manager_host {self.manager_host} not in [0, {self.n_hosts})")
        for h in self.storage_hosts + self.client_hosts:
            if not 0 <= h < self.n_hosts:
                raise ValueError(f"host {h} not in [0, {self.n_hosts})")
        if self.faults is not None:
            if self.faults.healthy:
                # normalize: a zero-fault scenario IS the healthy config —
                # same fingerprint, same compiled DAG, same everything
                # (the zero-fault pass-through property rides on this)
                object.__setattr__(self, "faults", None)
            else:
                if self.faults.max_storage_rank >= len(self.storage_hosts):
                    raise ValueError(
                        f"fault scenario references storage rank "
                        f"{self.faults.max_storage_rank} but config has "
                        f"{len(self.storage_hosts)} storage nodes")
                if self.faults.max_client_rank >= len(self.client_hosts):
                    raise ValueError(
                        f"fault scenario references client rank "
                        f"{self.faults.max_client_rank} but config has "
                        f"{len(self.client_hosts)} clients")

    @property
    def n_storage(self) -> int:
        return len(self.storage_hosts)

    @property
    def n_clients(self) -> int:
        return len(self.client_hosts)

    def replace(self, **kw) -> "StorageConfig":
        return dataclasses.replace(self, **kw)

    def fingerprint(self) -> str:
        """Structural fingerprint: digests every field that feeds
        `compile_workflow` (all of them do — host layout, manager, stripe
        width, replication, chunk size, placement, fault scenario). Equal
        fingerprints guarantee bit-identical compiled DAGs for the same
        workflow. The fault digest is appended only when a scenario is
        present, so healthy configs keep their pre-fault fingerprints —
        persisted DAG-cache entries stay warm across this change."""
        parts = (self.n_hosts, self.storage_hosts,
                 self.client_hosts, self.manager_host,
                 self.stripe_width, self.replication,
                 self.chunk_size, self.placement.value)
        if self.faults is not None:
            parts += (self.faults.fingerprint(),)
        return _fingerprint(*parts)


def collocated_config(n_hosts: int, *, stripe_width: int = 0, replication: int = 1,
                      chunk_size: int = 1 * MB,
                      placement: Placement = Placement.ROUND_ROBIN,
                      faults: Optional[FaultScenario] = None) -> StorageConfig:
    """The paper's default DSS deployment: manager on host 0, storage+client
    collocated on hosts 1..n_hosts-1."""
    workers = tuple(range(1, n_hosts))
    return StorageConfig(n_hosts=n_hosts, storage_hosts=workers, client_hosts=workers,
                         stripe_width=stripe_width, replication=replication,
                         chunk_size=chunk_size, placement=placement, faults=faults)


def partitioned_config(n_app: int, n_storage: int, *, stripe_width: int = 0,
                       replication: int = 1, chunk_size: int = 1 * MB,
                       placement: Placement = Placement.ROUND_ROBIN,
                       faults: Optional[FaultScenario] = None) -> StorageConfig:
    """Scenario-I style deployment: disjoint app and storage nodes,
    manager on host 0, storage on hosts 1..n_storage, clients after."""
    n_hosts = 1 + n_storage + n_app
    storage = tuple(range(1, 1 + n_storage))
    clients = tuple(range(1 + n_storage, n_hosts))
    return StorageConfig(n_hosts=n_hosts, storage_hosts=storage, client_hosts=clients,
                         stripe_width=stripe_width, replication=replication,
                         chunk_size=chunk_size, placement=placement, faults=faults)


@dataclass(frozen=True)
class ServiceTimes:
    """Model seed (§2.5): per-component service times.

    Rates are seconds/byte for data-bearing services and seconds/request
    for the manager. ``net_remote`` covers NIC serialization in each of
    the out- and in- queues; ``net_local`` is the loopback path.
    """

    net_remote: float          # s/byte through one NIC queue (out or in)
    net_local: float           # s/byte through the host loopback
    net_latency: float         # s fixed per message hop
    storage: float             # s/byte storage-service time (mu_sm)
    manager: float             # s/request manager-service time (mu_ma)
    client: float = 0.0        # paper sets T_cli := 0 (cost folded into manager)
    storage_req: float = 0.0   # s/chunk fixed storage-service cost (per-RPC part
                               # of mu_sm; what makes the chunk-size knob bite)

    def replace(self, **kw) -> "ServiceTimes":
        return dataclasses.replace(self, **kw)


# --- reference hardware profiles -------------------------------------------------
# The paper's testbed: Xeon E5345, 4 GB RAM, 1 Gbps NIC, RAMdisk-backed storage.
# 1 Gbps ~ 119 MB/s; loopback and RAMdisk are roughly an order of magnitude faster.
PAPER_RAMDISK = ServiceTimes(
    net_remote=1.0 / (119 * MB),
    net_local=1.0 / (2.2 * GB),
    net_latency=100e-6,
    storage=1.0 / (1.1 * GB),
    manager=0.4e-3,
    storage_req=0.3e-3,
)

# Spinning-disk profile (§5): the *predictor* uses a memoryless 100 MB/s
# service; the emulator adds history-dependent seeks on top.
PAPER_HDD = PAPER_RAMDISK.replace(storage=1.0 / (95 * MB))

# The reference's checkpoint-staging profile (25 GB/s NIC, NVMe-class
# nodes), kept under its name for API parity: a hypothetical what-if
# seed like any other, not a measurement of any machine.
TPU_POD_STAGING = ServiceTimes(
    net_remote=1.0 / (25 * GB),
    net_local=1.0 / (100 * GB),
    net_latency=10e-6,
    storage=1.0 / (6 * GB),
    manager=50e-6,
    storage_req=20e-6,
)


# --- workload description (§2.6) --------------------------------------------------

@dataclass(frozen=True)
class FileAttr:
    """Per-file configuration override (the paper models per-file policies
    as part of the workload description, after [11,8])."""

    placement: Optional[Placement] = None
    replication: Optional[int] = None
    collocate_group: Optional[str] = None   # files in a group land on one node


@dataclass
class Task:
    """One workflow stage instance: read inputs, compute, write outputs."""

    tid: int
    inputs: Tuple[str, ...]
    outputs: Tuple[Tuple[str, int], ...]       # (file name, size in bytes)
    runtime: float = 0.0                        # pure compute seconds
    client: Optional[int] = None                # fixed client index, or None = scheduler
    stage: str = ""                             # label for per-stage reporting
    file_attrs: Dict[str, FileAttr] = field(default_factory=dict)


@dataclass
class Workflow:
    """Tasks + implicit file dependency graph (producer -> consumers)."""

    tasks: List[Task]
    name: str = "workflow"
    # files that pre-exist in intermediate storage (e.g. the BLAST database),
    # mapping name -> (size, FileAttr or None)
    preloaded: Dict[str, Tuple[int, Optional[FileAttr]]] = field(default_factory=dict)

    def producers(self) -> Dict[str, int]:
        prod: Dict[str, int] = {}
        for t in self.tasks:
            for fname, _ in t.outputs:
                assert fname not in prod, f"file {fname} written twice"
                prod[fname] = t.tid
        return prod

    def validate(self) -> None:
        prod = self.producers()
        for t in self.tasks:
            for f in t.inputs:
                assert f in prod or f in self.preloaded, f"missing producer for {f}"

    def total_bytes(self) -> int:
        return sum(sz for t in self.tasks for _, sz in t.outputs)

    def fingerprint(self) -> str:
        """Structural fingerprint of everything `compile_workflow` reads.

        Covers the full task list *in order* (scheduling and placement
        state evolve task by task), per-task inputs/outputs/sizes/
        runtimes/pins/stage labels/file attrs, and the preloaded files in
        *insertion order* (the manager's round-robin cursor advances as
        they are placed). ``name`` is cosmetic and excluded. Two
        workflows with equal fingerprints compile to bit-identical
        `MicroOps` under the same `StorageConfig`."""
        return _fingerprint(
            [(t.tid, t.inputs, t.outputs, t.runtime, t.client, t.stage,
              sorted(t.file_attrs.items())) for t in self.tasks],
            list(self.preloaded.items()))


@dataclass
class RunReport:
    """Simulator output (§2.4): per-run aggregates."""

    makespan: float
    bytes_moved: int
    storage_used: int
    per_task_end: Dict[int, float] = field(default_factory=dict)
    per_stage_end: Dict[str, float] = field(default_factory=dict)
    n_events: int = 0
    failed: bool = False           # an op was unservable under the injected
                                   # fault scenario (no surviving replica /
                                   # no live storage node); makespan crossed
                                   # faults.FAILED_THRESHOLD
    timeline: Optional[object] = None
                                   # obs.timeline.Timeline when the caller
                                   # asked for one (simulate(timeline=True));
                                   # typed loosely so core types stay
                                   # decoupled from the obs layer

    def __post_init__(self):
        if self.makespan >= FAILED_THRESHOLD:
            self.failed = True
