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


# An emitted block holds one column an op, in op order, and one row a field.
# float64 holds every value the compiler emits exactly: ids, resources,
# classes and byte counts are integers far below 2**53.
_RES, _CLS, _NBYTES, _REQS, _EXTRA, _NLAT, _DEAD, _DEPS = range(8)
_NCOL = _DEPS + MAXD

# the steps of a chunk's chain (`_Emitter.emit_chains`), and the ops they
# emit: a dead op, a storage service, a hop's loopback op, a remote hop's
# send and receive
_ABSENT, _DEAD_STEP, _STORE, _HOP = range(4)
_OP_DEAD, _OP_STORE, _OP_LOOP, _OP_OUT, _OP_IN = range(5)
_STEP_OP = (-1, _OP_DEAD, _OP_STORE, _OP_LOOP)    # a step's first op


class _Emitter:
    """Builds the op table. Protocol ops (manager round trips, compute,
    small barriers) go one at a time through `op`; the per-chunk chains of
    a file and the levels of a barrier tree, whose shapes are known before
    they are emitted, go as NumPy blocks. The ops, their order and their
    ids are those of emitting each one through `op`."""

    def __init__(self, config: StorageConfig, mgr: Optional[Manager] = None,
                 degraded: Optional[Dict[int, float]] = None):
        self.cfg = config
        H = config.n_hosts
        self.H = H
        self.S = config.n_storage
        self.n_ops = 0            # ops emitted so far: the next op's id
        self.bulk_ops = 0         # of them, emitted in blocks
        self.picks = 0            # chunk reads resolved by `pick_replica`
        self.failovers = 0        # of them, served off replica ``j mod r``
        self._blocks: List[np.ndarray] = []   # float64[_NCOL, k] each
        self._rows: List[tuple] = []          # `op`'s ops not yet in a block
        self.bytes_moved = 0
        self.storage_idx = {h: i for i, h in enumerate(config.storage_hosts)}
        # per kind of chain op (`_OP_*`): its resource on each host (a
        # hop's receive on its destination, the others on their source; -1
        # where a host has no storage service), and its class, requests,
        # lag and whether it carries the step's bytes
        hosts = np.arange(H)
        self._op_res = np.stack([np.zeros(H, dtype=np.int64),
                                 np.full(H, -1, dtype=np.int64),
                                 1 + 2 * H + hosts, 1 + hosts, 1 + H + hosts])
        for h in self.storage_idx:
            self._op_res[_OP_STORE, h] = self.r_store(h)
        self._op_fields = np.array([[CLS_NONE, 0, 0, 0],
                                    [CLS_STORAGE, 1, 0, 1],
                                    [CLS_NET_LOCAL, 0, 1, 1],
                                    [CLS_NET_REMOTE, 0, 0, 1],
                                    [CLS_NET_REMOTE, 0, 1, 1]],
                                   dtype=np.float64)
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
           reqs: float = 0.0, extra: float = 0.0, nlat: float = 0.0) -> int:
        deps = [d for d in deps if d >= 0]
        if len(deps) > MAXD:
            deps = [self.barrier(deps)]
        self._rows.append((res, cls, nbytes, reqs, extra, nlat, 0.0,
                           *deps, *(-1,) * (MAXD - len(deps))))
        self.n_ops += 1
        return self.n_ops - 1

    def _flush(self) -> None:
        if self._rows:
            self._blocks.append(np.array(self._rows, dtype=np.float64).T)
            self._rows = []

    def _push(self, block: np.ndarray) -> None:
        """Append a block of ops after those emitted so far."""
        self._flush()
        self._blocks.append(block)
        self.n_ops += block.shape[1]
        self.bulk_ops += block.shape[1]

    def table(self) -> np.ndarray:
        """Every op emitted, float64[_NCOL, n_ops] in op order."""
        self._flush()
        return (np.concatenate(self._blocks, axis=1) if self._blocks
                else np.empty((_NCOL, 0)))

    def barrier(self, deps: Sequence[int]) -> int:
        """MAXD-ary zero-cost reduction tree on the dummy resource: each
        level groups its deps by MAXD in order, one op a group (a group of
        one passes its dep through); the root is emitted last."""
        if len(deps) > MAXD:
            d = np.asarray(deps, dtype=np.int64)
            while len(d) > MAXD:
                d = self._barrier_level(d)
            deps = d.tolist()
        return self.op(0, CLS_NONE, deps)

    def _barrier_level(self, d: np.ndarray) -> np.ndarray:
        """One level of `barrier`'s tree as a block; the next level's deps."""
        k = len(d) - (len(d) % MAXD == 1)        # a last group of one passes
        grp = np.concatenate([d[:k], np.full(-k % MAXD, -1)]).reshape(-1, MAXD)
        if (grp < 0).any():                     # `op` drops them: pack left
            grp = np.take_along_axis(
                grp, np.argsort(grp < 0, axis=1, kind="stable"), axis=1)
        block = np.zeros((_NCOL, len(grp)))
        block[_DEPS:] = grp.T
        ids = self.n_ops + np.arange(len(grp))
        self._push(block)
        return np.concatenate([ids, d[k:]])

    def hop(self, src: int, dst: int, nbytes: float, deps: Sequence[int]) -> int:
        """One network message src->dst. Returns the op id whose completion
        means the message arrived (subsequent lag applies via nlat)."""
        self.bytes_moved += int(nbytes)
        if src == dst:
            return self.op(self.r_loop(src), CLS_NET_LOCAL, deps, nbytes=nbytes, nlat=1.0)
        a = self.op(self.r_out(src), CLS_NET_REMOTE, deps, nbytes=nbytes)
        return self.op(self.r_in(dst), CLS_NET_REMOTE, [a], nbytes=nbytes, nlat=1.0)

    def emit_chains(self, dep: int, kind: np.ndarray, a: np.ndarray, b: np.ndarray,
               nbytes: np.ndarray) -> np.ndarray:
        """Emit one chain of ops a chunk, chunk after chunk, as one block.

        Row j of the int64[n_chunks, steps] arrays lists chunk j's steps in
        order: `_HOP` is `hop` a -> b of ``nbytes``, `_STORE` a storage
        service op on a, `_ABSENT` nothing, and `_DEAD_STEP` an unservable
        operation (a read with no surviving replica, a write with no live
        storage node): a dummy-resource op whose simulated duration is
        `faults.DEAD_TIME`, so the run's makespan crosses
        `faults.FAILED_THRESHOLD` and `RunReport.failed` is set. A chunk's
        first op waits for ``dep``, each later one for the op before it.
        Returns each chunk's last op."""
        n, steps = kind.shape
        kind, a, b, nbytes = kind.ravel(), a.ravel(), b.ravel(), nbytes.ravel()
        hop = kind == _HOP
        self.bytes_moved += int(nbytes[hop].sum())
        remote = hop & (a != b)
        # two op slots a step: its first op, and a remote hop's receive
        slots = np.empty((4, 2 * len(kind)), dtype=np.int64)
        slots[0, 0::2] = np.where(remote, _OP_OUT, np.take(_STEP_OP, kind))
        slots[0, 1::2] = _OP_IN
        slots[1, 0::2], slots[1, 1::2] = a, b
        slots[2] = np.repeat(nbytes, 2)
        slots[3, 0::2], slots[3, 1::2] = kind != _ABSENT, remote
        per_chunk = slots[3].reshape(n, 2 * steps).sum(axis=1)
        op, host, nb = slots[:3, slots[3] == 1]
        end = np.cumsum(per_chunk)
        cls, reqs, nlat, has_bytes = self._op_fields[op].T
        block = np.empty((_NCOL, len(op)))
        block[_RES] = self._op_res[op, host]
        block[_CLS] = cls
        block[_NBYTES] = nb * has_bytes
        block[_REQS] = reqs
        block[_EXTRA] = 0.0
        block[_NLAT] = nlat
        block[_DEAD] = op == _OP_DEAD
        block[_DEPS] = self.n_ops + np.arange(-1, len(op) - 1)
        block[_DEPS, end - per_chunk] = dep
        block[_DEPS + 1:] = -1
        last = self.n_ops + end - 1
        self._push(block)
        return last

    # protocol-level emission (§2.4 write/read walk-throughs) -------------------
    def emit_write(self, client_host: int, loc: FileLoc, deps: Sequence[int]) -> int:
        m = self.cfg.manager_host
        # 1. allocation request -> manager -> reply  (manager request #1)
        a = self.hop(client_host, m, CTRL_BYTES, deps)
        b = self.op(self.r_manager, CLS_MANAGER, [a], reqs=1.0)
        reply = self.hop(m, client_host, CTRL_BYTES, [b])
        # 2. chunk stores, round-robin over the allocated stripe; each chunk:
        #    client -> primary storage service -> replica chain. Placement
        #    gives every chunk of a file a chain of one length, or none at
        #    all when no live storage node remains: a dead op a chunk
        n, r = loc.n_chunks, len(loc.chunks[0]) if loc.chunks else 0
        chain = np.array(loc.chunks, dtype=np.int64).reshape(n, r)
        if r == 0:
            kind = np.full((n, 1), _DEAD_STEP)
            src = dst = np.zeros((n, 1), dtype=np.int64)
        else:
            kind = np.tile([_HOP, _STORE], (n, r))
            dst = np.repeat(chain, 2, axis=1)
            src = dst.copy()
            src[:, 0] = client_host
            src[:, 2::2] = chain[:, :-1]
        cb = np.repeat(_chunk_bytes(loc)[:, None], kind.shape[1], axis=1)
        chunk_done = self.emit_chains(reply, kind, src, dst, cb)
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
        # load-balance over replicas (chunk j -> j mod r); under faults
        # the manager fails over to a surviving replica, steering to
        # the least-degraded one — None (-1) means the chunk is lost
        if self.mgr.dead or self.degraded:
            picks = (self.mgr.pick_replica(c, j, self.degraded)
                     for j, c in enumerate(loc.chunks))
            src = np.fromiter((-1 if h is None else h for h in picks),
                              np.int64, loc.n_chunks)
            self.picks += loc.n_chunks
            self.failovers += int(np.count_nonzero(
                (src >= 0) & (src != loc.default_replicas)))
        else:
            src = loc.default_replicas
        # chunk request, storage service, data transfer back
        n, c, cb = loc.n_chunks, np.full(loc.n_chunks, client_host), _chunk_bytes(loc)
        kind = np.where((src < 0)[:, None], [_DEAD_STEP, _ABSENT, _ABSENT],
                        [_HOP, _STORE, _HOP])
        chunk_done = self.emit_chains(
            reply, kind, np.stack([c, src, src], axis=1),
            np.stack([src, src, c], axis=1),
            np.stack([np.full(n, CTRL_BYTES), cb, cb], axis=1))
        return self.barrier(chunk_done)


def _chunk_bytes(loc: FileLoc) -> np.ndarray:
    """int64[n_chunks]: `FileLoc.chunk_bytes` of every chunk."""
    cb = np.full(loc.n_chunks, loc.chunk_size, dtype=np.int64)
    if loc.n_chunks:
        cb[-1] = loc.chunk_bytes(loc.n_chunks - 1)
    return cb


def compile_workflow(wf: Workflow, cfg: StorageConfig, *,
                     locality_aware: bool = True,
                     counts: Optional[Dict[str, int]] = None) -> MicroOps:
    """Compile a workflow into the micro-op DAG.

    Tasks must be listed in a valid topological order (producers before
    consumers); `Workflow.validate` checks producer existence.
    ``counts``, if given, receives ``bulk_ops``: how many of the DAG's ops
    were emitted in blocks (chunk chains and barrier-tree levels); and
    what the fault path did (docs/faults.md), 0 on a healthy compile:
    ``faulted`` (1 when the config carries a scenario), ``picks`` (chunk
    reads resolved by `Manager.pick_replica`), ``failovers`` (of them,
    served by another replica than ``j mod r``; a lost chunk is a dead
    op, not a failover), ``dead_ops`` and ``kills`` (deaths that fired).
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

    kills = 0

    def activate_kills(upto: int) -> None:
        nonlocal kills
        while kill_at and kill_at[0][0] <= upto:
            mgr.kill(kill_at.pop(0)[1])
            kills += 1

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
    table = b.table()
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
        if table[_DEAD].any():
            dead_arr = table[_DEAD].copy()

    ops = MicroOps(
        res=table[_RES].astype(np.int32),
        cls=table[_CLS].astype(np.int8),
        nbytes=table[_NBYTES].copy(),
        reqs=table[_REQS].copy(),
        extra=table[_EXTRA].copy(),
        nlat=table[_NLAT].copy(),
        deps=np.ascontiguousarray(table[_DEPS:].T, dtype=np.int32),
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
    if counts is not None:
        counts.update(bulk_ops=b.bulk_ops, faulted=int(scenario is not None),
                      picks=b.picks, failovers=b.failovers,
                      dead_ops=0 if dead_arr is None else int(dead_arr.sum()),
                      kills=kills)
    return ops
