"""Workload compiler: (Workflow, StorageConfig) -> static micro-op DAG.

The paper's simulator processes a dynamic event queue; on accelerators we
need static shapes. Because (a) placement is a deterministic function of
the manager state and (b) the workflow task->client assignment can be
fixed ahead of time (the paper's own harness uses an "idealized image" of
the application, §5), the *structure* of every simulated event is known
before simulation. Only the *times* are unknown. We therefore compile
the run into flat arrays of micro-ops — one op per (resource, service)
occupation — and let the simulator assign times.

Each micro-op i:
    res[i]    resource id it occupies (FIFO single-server queue)
    cls[i]    service class: selects the byte-rate / request-rate from
              ServiceTimes, so service times stay sweepable per candidate
    nbytes[i] data bytes served
    reqs[i]   request count (manager/client per-request service)
    extra[i]  fixed seconds (task compute time)
    nlat[i]   1.0 if a network propagation lag follows this op (the lag
              delays dependents but does NOT occupy the queue)
    deps[i,:] up to MAXD predecessor op ids (-1 = none); fan-in larger
              than MAXD is reduced through zero-cost barrier trees

Resource map (R = 1 + 4H + S + 1):
    0                      dummy (barriers)
    1      + h             out-queue of host h
    1 +  H + h             in-queue of host h
    1 + 2H + h             loopback of host h
    1 + 3H + h             cpu of host h
    1 + 4H + s             storage service s (index into storage_hosts)
    1 + 4H + S             manager service
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .faults import FaultScenario
from .placement import FileLoc, Manager
from .types import (CTRL_BYTES, FileAttr, Placement, StorageConfig, Task,
                    Workflow)

MAXD = 4

# process-wide count of compile_workflow executions; ground truth for the
# compile-cache counters (benchmarks/tests assert a warm sweep leaves it flat)
_N_COMPILES = 0
_N_COMPILES_LOCK = threading.Lock()


def compile_count() -> int:
    """How many times `compile_workflow` has run in this process."""
    return _N_COMPILES

# service classes
CLS_NONE, CLS_NET_REMOTE, CLS_NET_LOCAL, CLS_STORAGE, CLS_MANAGER, CLS_CLIENT, CLS_CPU = range(7)
N_CLS = 7


@dataclass
class MicroOps:
    """The compiled DAG plus reporting metadata."""

    res: np.ndarray        # int32[N]
    cls: np.ndarray        # int8[N]
    nbytes: np.ndarray     # float64[N]
    reqs: np.ndarray       # float64[N]
    extra: np.ndarray      # float64[N]
    nlat: np.ndarray       # float64[N]
    deps: np.ndarray       # int32[N, MAXD]
    n_resources: int
    # reporting
    task_end_op: Dict[int, int] = field(default_factory=dict)
    stage_of_task: Dict[int, str] = field(default_factory=dict)
    file_write_op: Dict[str, int] = field(default_factory=dict)
    bytes_moved: int = 0
    storage_used: int = 0
    # fault injection (docs/faults.md) — None for healthy compiles, so a
    # healthy MicroOps is byte-for-byte what the pre-fault compiler built
    res_mult: Optional[np.ndarray] = None   # float64[n_resources] service-time
                                            # multiplier (degraded disks /
                                            # stragglers)
    dead: Optional[np.ndarray] = None       # float64[N] 1.0 = unservable op
                                            # (dead node, no surviving replica)

    @property
    def n_ops(self) -> int:
        return int(self.res.shape[0])

    @property
    def shape_signature(self) -> Tuple[int, int]:
        """(n_ops, n_resources) — everything that determines the compiled
        simulator's array shapes (the sweep engine buckets on this)."""
        return (self.n_ops, self.n_resources)


class _Emitter:
    def __init__(self, config: StorageConfig, mgr: Optional[Manager] = None,
                 degraded: Optional[Dict[int, float]] = None):
        self.cfg = config
        H = config.n_hosts
        self.H = H
        self.S = config.n_storage
        self.res: List[int] = []
        self.cls: List[int] = []
        self.nbytes: List[float] = []
        self.reqs: List[float] = []
        self.extra: List[float] = []
        self.nlat: List[float] = []
        self.deps: List[List[int]] = []
        self.dead_flags: List[float] = []
        self.bytes_moved = 0
        self.storage_idx = {h: i for i, h in enumerate(config.storage_hosts)}
        # the manager supplies read-side replica choice (failover +
        # degradation steering); degraded maps host -> service multiplier
        self.mgr = mgr if mgr is not None else Manager(config)
        self.degraded = degraded or {}

    # resource ids -----------------------------------------------------------
    def r_out(self, h: int) -> int: return 1 + h
    def r_in(self, h: int) -> int: return 1 + self.H + h
    def r_loop(self, h: int) -> int: return 1 + 2 * self.H + h
    def r_cpu(self, h: int) -> int: return 1 + 3 * self.H + h
    def r_store(self, h: int) -> int: return 1 + 4 * self.H + self.storage_idx[h]
    @property
    def r_manager(self) -> int: return 1 + 4 * self.H + self.S
    @property
    def n_resources(self) -> int: return 1 + 4 * self.H + self.S + 1

    # op emission --------------------------------------------------------------
    def op(self, res: int, cls: int, deps: Sequence[int], *, nbytes: float = 0.0,
           reqs: float = 0.0, extra: float = 0.0, nlat: float = 0.0,
           dead: bool = False) -> int:
        deps = [d for d in deps if d >= 0]
        if len(deps) > MAXD:
            deps = [self.barrier(deps)]
        i = len(self.res)
        self.res.append(res)
        self.cls.append(cls)
        self.nbytes.append(float(nbytes))
        self.reqs.append(float(reqs))
        self.extra.append(float(extra))
        self.nlat.append(float(nlat))
        self.deps.append(list(deps) + [-1] * (MAXD - len(deps)))
        self.dead_flags.append(1.0 if dead else 0.0)
        return i

    def dead_op(self, deps: Sequence[int]) -> int:
        """An unservable operation (read with no surviving replica, write
        with no live storage node): a dummy-resource op whose simulated
        duration is `faults.DEAD_TIME`, so the run's makespan crosses
        `faults.FAILED_THRESHOLD` and `RunReport.failed` is set."""
        return self.op(0, CLS_NONE, deps, dead=True)

    def barrier(self, deps: Sequence[int]) -> int:
        """MAXD-ary zero-cost reduction tree on the dummy resource."""
        deps = list(deps)
        if not deps:
            deps = [-1]
        while len(deps) > MAXD:
            nxt = []
            for k in range(0, len(deps), MAXD):
                grp = deps[k:k + MAXD]
                nxt.append(self.op(0, CLS_NONE, grp) if len(grp) > 1 else grp[0])
            deps = nxt
        return self.op(0, CLS_NONE, deps)

    def hop(self, src: int, dst: int, nbytes: float, deps: Sequence[int]) -> int:
        """One network message src->dst. Returns the op id whose completion
        means the message arrived (subsequent lag applies via nlat)."""
        self.bytes_moved += int(nbytes)
        if src == dst:
            return self.op(self.r_loop(src), CLS_NET_LOCAL, deps, nbytes=nbytes, nlat=1.0)
        a = self.op(self.r_out(src), CLS_NET_REMOTE, deps, nbytes=nbytes)
        return self.op(self.r_in(dst), CLS_NET_REMOTE, [a], nbytes=nbytes, nlat=1.0)

    # protocol-level emission (§2.4 write/read walk-throughs) -------------------
    def emit_write(self, client_host: int, loc: FileLoc, deps: Sequence[int]) -> int:
        m = self.cfg.manager_host
        # 1. allocation request -> manager -> reply  (manager request #1)
        a = self.hop(client_host, m, CTRL_BYTES, deps)
        b = self.op(self.r_manager, CLS_MANAGER, [a], reqs=1.0)
        reply = self.hop(m, client_host, CTRL_BYTES, [b])
        # 2. chunk stores, round-robin over the allocated stripe; each chunk:
        #    client -> primary storage service -> replica chain
        chunk_done: List[int] = []
        for j in range(loc.n_chunks):
            cb = loc.chunk_bytes(j)
            chain = loc.chunks[j]
            if not chain:                       # no live storage node remains
                chunk_done.append(self.dead_op([reply]))
                continue
            d = self.hop(client_host, chain[0], cb, [reply])
            d = self.op(self.r_store(chain[0]), CLS_STORAGE, [d], nbytes=cb, reqs=1.0)
            for prev, nxt in zip(chain, chain[1:]):
                d = self.hop(prev, nxt, cb, [d])
                d = self.op(self.r_store(nxt), CLS_STORAGE, [d], nbytes=cb, reqs=1.0)
            chunk_done.append(d)
        # acks are not charged (paper §2: ack time does not tangibly impact accuracy)
        allc = self.barrier(chunk_done)
        # 3. chunk-map commit -> manager -> ack      (manager request #2)
        c = self.hop(client_host, m, CTRL_BYTES, [allc])
        d = self.op(self.r_manager, CLS_MANAGER, [c], reqs=1.0)
        return self.hop(m, client_host, CTRL_BYTES, [d])

    def emit_read(self, client_host: int, loc: FileLoc, deps: Sequence[int]) -> int:
        m = self.cfg.manager_host
        a = self.hop(client_host, m, CTRL_BYTES, deps)
        b = self.op(self.r_manager, CLS_MANAGER, [a], reqs=1.0)
        reply = self.hop(m, client_host, CTRL_BYTES, [b])
        chunk_done: List[int] = []
        for j in range(loc.n_chunks):
            cb = loc.chunk_bytes(j)
            # load-balance over replicas (chunk j -> j mod r); under faults
            # the manager fails over to a surviving replica, steering to
            # the least-degraded one — None means the chunk is lost
            src = self.mgr.pick_replica(loc.chunks[j], j, self.degraded)
            if src is None:
                chunk_done.append(self.dead_op([reply]))
                continue
            d = self.hop(client_host, src, CTRL_BYTES, [reply])          # chunk request
            d = self.op(self.r_store(src), CLS_STORAGE, [d], nbytes=cb, reqs=1.0)  # storage service
            d = self.hop(src, client_host, cb, [d])                      # data transfer
            chunk_done.append(d)
        return self.barrier(chunk_done)


def compile_workflow(wf: Workflow, cfg: StorageConfig, *,
                     locality_aware: bool = True) -> MicroOps:
    """Compile a workflow into the micro-op DAG.

    Tasks must be listed in a valid topological order (producers before
    consumers); `Workflow.validate` checks producer existence.
    """
    global _N_COMPILES
    with _N_COMPILES_LOCK:
        _N_COMPILES += 1
    wf.validate()
    mgr = Manager(cfg)

    # --- fault scenario -> degradation map + death schedule -------------------
    # Deaths trigger on workflow *progress* (task placements / stage
    # completion), keeping the compiled DAG static-shaped; see docs/faults.md.
    scenario: Optional[FaultScenario] = cfg.faults
    degraded: Dict[int, float] = {}
    kill_at: List[Tuple[int, int]] = []       # (activation task index, host)
    if scenario is not None:
        degraded = {cfg.storage_hosts[d.node]: d.factor
                    for d in scenario.degraded}
        last_of_stage: Dict[str, int] = {}
        for i, t in enumerate(wf.tasks):
            last_of_stage[t.stage] = i
        for fl in scenario.failures:
            host = cfg.storage_hosts[fl.node]
            if fl.after_stage is not None:
                idx = last_of_stage.get(fl.after_stage)
                # a stage the workflow never runs completes never
                act = (idx + 1) if idx is not None else len(wf.tasks) + 1
            elif fl.after_tasks is not None:
                act = fl.after_tasks
            else:
                act = -1                      # dead before preloaded placement
            kill_at.append((act, host))
        kill_at.sort()

    def activate_kills(upto: int) -> None:
        while kill_at and kill_at[0][0] <= upto:
            mgr.kill(kill_at.pop(0)[1])

    b = _Emitter(cfg, mgr, degraded)

    activate_kills(-1)
    for fname, (size, attr) in wf.preloaded.items():
        mgr.place(fname, size, cfg.manager_host, attr)  # pre-existing: no write ops

    # Placement of a task's outputs depends on its client host, and WASS
    # assignment depends on placement of its *inputs* — both resolve in one
    # topological pass because inputs are placed before consumers appear.
    file_write_op: Dict[str, int] = {n: -1 for n in wf.preloaded}
    task_end: Dict[int, int] = {}
    last_on_client: Dict[int, int] = {}
    assign: Dict[int, int] = {}
    load = [0] * cfg.n_clients
    host_to_client = {h: i for i, h in enumerate(cfg.client_hosts)}

    for task_idx, t in enumerate(wf.tasks):
        activate_kills(task_idx)
        # --- schedule ---------------------------------------------------------
        if t.client is not None:
            c = t.client
        else:
            c = None
            if locality_aware and t.inputs:
                hosts = set()
                for f in t.inputs:
                    loc = mgr.files.get(f)
                    h = loc.single_host() if loc is not None else None
                    if h is None:
                        hosts = set()
                        break
                    hosts.add(h)
                if len(hosts) == 1:
                    h = hosts.pop()
                    c = host_to_client.get(h)
            if c is None:
                c = min(range(cfg.n_clients), key=lambda k: (load[k], k))
        assign[t.tid] = c
        load[c] += 1
        chost = cfg.client_hosts[c]

        # --- start barrier: inputs ready + client free --------------------------
        start_deps = [file_write_op[f] for f in t.inputs]
        if c in last_on_client:
            start_deps.append(last_on_client[c])
        start = b.barrier(start_deps)

        # --- reads (concurrent; NIC FIFO serializes) ----------------------------
        read_ends = [b.emit_read(chost, mgr.lookup(f), [start]) for f in t.inputs]
        ready = b.barrier(read_ends) if read_ends else start

        # --- compute -----------------------------------------------------------
        comp = b.op(b.r_cpu(chost), CLS_CPU, [ready], extra=t.runtime)

        # --- writes -------------------------------------------------------------
        write_ends = []
        for fname, size in t.outputs:
            loc = mgr.place(fname, size, chost, t.file_attrs.get(fname))
            w = b.emit_write(chost, loc, [comp])
            file_write_op[fname] = w
            write_ends.append(w)
        end = b.barrier(write_ends + [comp])
        task_end[t.tid] = end
        last_on_client[c] = end

    # --- bake the scenario into per-resource multipliers + death mask ---------
    # None for healthy compiles: the arrays (and the simulator branches
    # that would consume them) only exist when a scenario asks for them
    res_mult: Optional[np.ndarray] = None
    dead_arr: Optional[np.ndarray] = None
    if scenario is not None:
        if degraded or scenario.stragglers:
            rm = np.ones(b.n_resources, dtype=np.float64)
            for host, f in degraded.items():
                rm[b.r_store(host)] *= f
            for s in scenario.stragglers:
                rm[b.r_cpu(cfg.client_hosts[s.rank])] *= s.factor
            res_mult = rm
        if any(b.dead_flags):
            dead_arr = np.asarray(b.dead_flags, dtype=np.float64)

    ops = MicroOps(
        res=np.asarray(b.res, dtype=np.int32),
        cls=np.asarray(b.cls, dtype=np.int8),
        nbytes=np.asarray(b.nbytes, dtype=np.float64),
        reqs=np.asarray(b.reqs, dtype=np.float64),
        extra=np.asarray(b.extra, dtype=np.float64),
        nlat=np.asarray(b.nlat, dtype=np.float64),
        deps=np.asarray(b.deps, dtype=np.int32).reshape(-1, MAXD),
        n_resources=b.n_resources,
        task_end_op=task_end,
        stage_of_task={t.tid: t.stage for t in wf.tasks},
        file_write_op={k: v for k, v in file_write_op.items() if v >= 0},
        bytes_moved=b.bytes_moved,
        storage_used=mgr.storage_used(),
        res_mult=res_mult,
        dead=dead_arr,
    )
    # sanity: DAG is topologically ordered by construction
    assert (ops.deps < np.arange(ops.n_ops)[:, None]).all(), "non-topological DAG"
    return ops
