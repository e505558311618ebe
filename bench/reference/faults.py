"""The fault path, plainly: storage nodes lost part-way through a job,
disks that serve slower and slow clients, on top of the healthy
reference (`compiler` and `scan`, used as they are).

Written from the documented semantics (the program's docs/faults.md and
the docstrings of its core/faults.py and core/placement.py), not from
its code. A scenario is a dict of storage and client *ranks* (positions
in the deployment's ``storage_hosts`` and ``client_hosts``):

    {"kill": [(rank, after_tasks), ...],  # after_tasks None: dead before
                                          # anything is placed
     "degraded": {rank: factor, ...},     # that node's disk, factor x slower
     "slow": {rank: factor, ...}}         # that client's compute

- **Death by placement progress.** A node killed after k tasks survives
  the first k task placements: it dies just before task k (counted from
  0) is placed, after the preloaded files when k is 0. A k past the
  last task never fires.
- **Writes after a death** draw their stripe and replica chains from the
  live storage nodes only: the round-robin cursor runs over the live
  list. Files placed earlier keep their chains.
- **Reads fail over.** Chunk j of a file is read from its chain rotated
  to start at replica ``j mod r``, the dead skipped, taking the replica
  on the least degraded disk (the first of equals in the rotation). With
  nothing dead and nothing degraded that is replica ``j mod r``.
- **Dead ops.** A read whose chunk has no live replica, and a write
  with no live storage node, is one op on the dummy resource that costs
  `DEAD_TIME` seconds, in place of that chunk's ops.
- **Multipliers.** A degraded disk multiplies the durations of its
  storage service; a slow client those of its cpu. The network queues
  are unaffected.
- **Verdict.** A run whose makespan reaches `FAILED_THRESHOLD` could not
  be served: it is ``failed``, and its makespan is a penalty.

The serving order and the FIFO recurrence are `scan`'s, unchanged: the
durations with their multipliers and dead ops are handed to it as bytes
at one second a byte (``x * 1.0 + 0.0`` is ``x``), with the lags as
they are.

Departures from the program's documented semantics: a death triggered
by the end of a named stage (``after_stage``) is not modelled, since the
reference's workflows carry no stages; the placement policies are those
of `compiler._Manager`.
"""
from __future__ import annotations

import numpy as np

from . import compiler, scan
from .compiler import CTRL_BYTES, NONE, STORAGE

DEAD_TIME = 1e30            # seconds an unservable op costs
FAILED_THRESHOLD = 1e29     # a makespan at or past it is a failed run


def failed(makespan: float) -> bool:
    return makespan >= FAILED_THRESHOLD


class _Manager(compiler._Manager):
    """`compiler._Manager` with a dead set: every placement made after a
    death draws from the live storage nodes."""

    def __init__(self, dep):
        super().__init__(dep)
        self.dead = set()

    def _live(self):
        return [h for h in self.dep["storage_hosts"] if h not in self.dead]

    def _stripe(self, width):
        s = self._live()
        start = self.cursor % len(s) if s else 0
        self.cursor += 1
        return [s[(start + i) % len(s)] for i in range(min(width, len(s)))]

    def _chain(self, primary, r):
        s = self._live()
        i = s.index(primary)
        return [s[(i + k) % len(s)] for k in range(min(r, len(s)))]

    def place(self, name, size, writer, attr):
        dep = self.dep
        attr = attr or {}
        policy = attr.get("placement") or dep["placement"]
        repl = attr.get("replication") or dep["replication"]
        n_chunks = -(-size // dep["chunk_size"])
        if (policy == "local" and writer in dep["storage_hosts"]
                and writer not in self.dead):
            targets = [writer] * n_chunks
        elif policy == "collocate":
            group = attr.get("group") or name
            node = self.targets.get(group)
            if node is None or node in self.dead:
                stripe = self._stripe(1)
                node = stripe[0] if stripe else None
                if node is not None:
                    self.targets[group] = node
            targets = [node] * n_chunks
        else:
            stripe = self._stripe(min(dep["stripe_width"],
                                      len(dep["storage_hosts"])))
            targets = [stripe[j % len(stripe)] if stripe else None
                       for j in range(n_chunks)]
        chains = [self._chain(t, repl) if t is not None else []
                  for t in targets]
        self.files[name] = (size, chains)
        return size, chains

    def single_host(self, name):
        chains = self.files[name][1]
        if any(not c for c in chains):
            return None
        return super().single_host(name)


class _Ops(compiler._Ops):
    """`compiler._Ops` with a dead flag an op, and reads and writes that
    meet dead nodes. Counts what the fault path did."""

    def __init__(self, dep, mgr, degraded):
        super().__init__(dep)
        self.mgr = mgr
        self.degraded = degraded        # host -> factor
        self.dead = []
        self.picks = self.failovers = 0

    def op(self, res, cls, deps, nbytes=0.0, reqs=0.0, extra=0.0, nlat=0.0,
           dead=0.0):
        i = super().op(res, cls, deps, nbytes=nbytes, reqs=reqs, extra=extra,
                       nlat=nlat)
        self.dead.append(float(dead))
        return i

    def dead_op(self, dep):
        return self.op(0, NONE, [dep], dead=1.0)

    def pick(self, chain, j):
        """The replica chunk ``j`` is read from, or None when none lives.
        Counted as a pick while a node is dead or a disk degraded, and as
        a failover when a live replica other than ``j mod r`` serves."""
        faulted = bool(self.mgr.dead or self.degraded)
        self.picks += faulted
        if not chain:
            return None
        k = j % len(chain)
        live = [h for h in chain[k:] + chain[:k] if h not in self.mgr.dead]
        if not live:
            return None
        best = live[0]
        for h in live[1:]:
            if self.degraded.get(h, 1.0) < self.degraded.get(best, 1.0):
                best = h
        self.failovers += faulted and best != chain[k]
        return best

    def write(self, client, size, chains, deps):
        reply = self.ask_manager(client, deps)
        n, ck = len(chains), self.dep["chunk_size"]
        done = []
        for j, chain in enumerate(chains):
            if not chain:
                done.append(self.dead_op(reply))
                continue
            cb = compiler._chunk_bytes(size, ck, n, j)
            d = self.hop(client, chain[0], cb, [reply])
            d = self.op(self.store(chain[0]), STORAGE, [d], nbytes=cb, reqs=1.0)
            for prev, nxt in zip(chain, chain[1:]):
                d = self.hop(prev, nxt, cb, [d])
                d = self.op(self.store(nxt), STORAGE, [d], nbytes=cb, reqs=1.0)
            done.append(d)
        all_chunks = self.barrier(done)
        return self.ask_manager(client, [all_chunks])

    def read(self, client, size, chains, deps):
        reply = self.ask_manager(client, deps)
        n, ck = len(chains), self.dep["chunk_size"]
        done = []
        for j, chain in enumerate(chains):
            src = self.pick(chain, j)
            if src is None:
                done.append(self.dead_op(reply))
                continue
            cb = compiler._chunk_bytes(size, ck, n, j)
            d = self.hop(client, src, CTRL_BYTES, [reply])
            d = self.op(self.store(src), STORAGE, [d], nbytes=cb, reqs=1.0)
            done.append(self.hop(src, client, cb, [d]))
        return self.barrier(done)


def compile_dag(wf, dep, scenario, *, locality_aware=True):
    """`compiler.compile_dag`'s DAG under ``scenario``, plus ``dead``
    (1.0 an unservable op), ``mult`` (a service-time multiplier a
    resource) and ``counts`` (``picks``, ``failovers``, ``dead_ops``,
    ``kills``)."""
    storage, clients = dep["storage_hosts"], dep["client_hosts"]
    mgr = _Manager(dep)
    degraded = {storage[r]: f for r, f in scenario.get("degraded", {}).items()}
    b = _Ops(dep, mgr, degraded)
    pending = sorted((-1 if k is None else k, storage[r])
                     for r, k in scenario.get("kill", ()))
    kills = 0

    def die_before(step):
        nonlocal kills
        while pending and pending[0][0] <= step:
            mgr.dead.add(pending.pop(0)[1])
            kills += 1

    die_before(-1)
    for name, size, attr in wf["preloaded"]:
        mgr.place(name, size, dep["manager_host"], attr)
    written = {name: -1 for name, _, _ in wf["preloaded"]}
    client_of_host = {h: i for i, h in enumerate(clients)}
    load = [0] * len(clients)
    last_on = {}
    for k, t in enumerate(wf["tasks"]):
        die_before(k)
        c = t["client"]
        if c is None:
            if locality_aware and t["inputs"]:
                hosts = {mgr.single_host(f) for f in t["inputs"]}
                if len(hosts) == 1 and None not in hosts:
                    c = client_of_host.get(hosts.pop())
            if c is None:
                c = min(range(len(clients)), key=lambda i: (load[i], i))
        load[c] += 1
        host = clients[c]
        start_deps = [written[f] for f in t["inputs"]]
        if c in last_on:
            start_deps.append(last_on[c])
        start = b.barrier(start_deps)
        reads = [b.read(host, *mgr.files[f], [start]) for f in t["inputs"]]
        ready = b.barrier(reads) if reads else start
        comp = b.op(1 + 3 * b.H + host, compiler.CPU, [ready],
                    extra=t["runtime"])
        ends = []
        for name, size in t["outputs"]:
            size, chains = mgr.place(name, size, host, t["attrs"].get(name))
            w = b.write(host, size, chains, [comp])
            written[name] = w
            ends.append(w)
        last_on[c] = b.barrier(ends + [comp])
    res, cls, nbytes, reqs, extra, nlat, deps = b.cols
    n_resources = 1 + 4 * b.H + b.S + 1
    mult = np.ones(n_resources)
    for host, f in degraded.items():
        mult[b.store(host)] *= f
    for r, f in scenario.get("slow", {}).items():
        mult[1 + 3 * b.H + clients[r]] *= f
    dead = np.asarray(b.dead, dtype=np.float64)
    return {"res": np.asarray(res, dtype=np.int32),
            "cls": np.asarray(cls, dtype=np.int8),
            "nbytes": np.asarray(nbytes, dtype=np.float64),
            "reqs": np.asarray(reqs, dtype=np.float64),
            "extra": np.asarray(extra, dtype=np.float64),
            "nlat": np.asarray(nlat, dtype=np.float64),
            "deps": np.asarray(deps, dtype=np.int32).reshape(-1, compiler.MAXD),
            "n_resources": n_resources, "dead": dead, "mult": mult,
            "counts": {"picks": b.picks, "failovers": b.failovers,
                       "dead_ops": int(dead.sum()), "kills": kills}}


def durations(dag, p):
    """Each op's service duration under profile ``p``: `scan.durations`
    times its resource's multiplier, plus `DEAD_TIME` on a dead op."""
    dur, _ = scan.durations(dag, p)
    mult = dag["mult"].tolist()
    out = []
    for d, r, x in zip(dur, dag["res"].tolist(), dag["dead"].tolist()):
        if mult[r] != 1.0:
            d = d * mult[r]
        if x:
            d = d + DEAD_TIME
        out.append(d)
    return out


def _as_bytes(dag, p):
    """The DAG and profile `scan` serves: every op one second a byte of
    its duration, its lag as it was."""
    n = len(dag["res"])
    flat = {"res": dag["res"], "deps": dag["deps"], "nlat": dag["nlat"],
            "n_resources": dag["n_resources"],
            "cls": np.full(n, compiler.NET_REMOTE, dtype=np.int8),
            "nbytes": np.asarray(durations(dag, p), dtype=np.float64),
            "reqs": np.zeros(n), "extra": np.zeros(n)}
    unit = dict.fromkeys(scan.PROFILE_KEYS, 0.0)
    unit.update(net_remote=1.0, net_latency=p["net_latency"])
    return flat, unit


class Dag:
    """One faulted DAG with its serving order under ``p_ref``."""

    def __init__(self, dag, p_ref):
        self.dag = dag
        self.deps = scan._deps(dag)
        flat, unit = _as_bytes(dag, p_ref)
        self.order = scan.serving_order(flat, unit, self.deps)

    def makespan(self, p):
        flat, unit = _as_bytes(self.dag, p)
        return scan.makespan(flat, self.order, unit, self.deps)
