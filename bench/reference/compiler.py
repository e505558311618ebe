"""Workflow + storage deployment -> micro-op DAG, for a healthy cluster.

One op per occupation of one FIFO resource (PDSW'13 §2.4's write and
read walk-throughs): control messages to the manager, chunk transfers
through the hosts' NIC queues or loopback, storage service, compute.
Fan-in wider than four dependencies goes through zero-cost barrier
trees on a dummy resource. The order in which ops are emitted is part
of the result: the scan serves ties by it.

Resources (H hosts, S storage nodes): 0 dummy; 1 + h out-queue of host
h; 1 + H + h its in-queue; 1 + 2H + h its loopback; 1 + 3H + h its cpu;
1 + 4H + s storage service s; 1 + 4H + S the manager.

A deployment is a dict: ``n_hosts``, ``storage_hosts``, ``client_hosts``,
``manager_host``, ``stripe_width`` (0 = all storage nodes),
``replication``, ``chunk_size``, ``placement`` (``round_robin``,
``local``, ``collocate`` or ``broadcast``).
"""
from __future__ import annotations

import numpy as np

MAXD = 4
KB = 1 << 10
CTRL_BYTES = 1 * KB        # every control message has the same size (§5)

# service classes: which rate of a profile an op is charged at
NONE, NET_REMOTE, NET_LOCAL, STORAGE, MANAGER, CLIENT, CPU = range(7)


def partitioned(n_app, n_storage, **knobs):
    """Scenario I: manager on host 0, storage on 1..S, app nodes after."""
    n_hosts = 1 + n_storage + n_app
    return _deployment(n_hosts, list(range(1, 1 + n_storage)),
                       list(range(1 + n_storage, n_hosts)), **knobs)


def collocated(n_hosts, **knobs):
    """The paper's testbed: manager on host 0, a storage node and a client
    on each of the other hosts."""
    workers = list(range(1, n_hosts))
    return _deployment(n_hosts, workers, list(workers), **knobs)


def _deployment(n_hosts, storage, clients, *, chunk_size, stripe_width=0,
                replication=1, placement="round_robin"):
    return {"n_hosts": n_hosts, "storage_hosts": storage,
            "client_hosts": clients, "manager_host": 0,
            "stripe_width": stripe_width or len(storage),
            "replication": replication, "chunk_size": chunk_size,
            "placement": placement}


class _Manager:
    """Where each file's chunks and replicas live: a round-robin cursor
    over the storage nodes, and the per-file policies."""

    def __init__(self, dep):
        self.dep = dep
        self.cursor = 0
        self.targets = {}           # collocate group -> node
        self.files = {}             # name -> (size, [replica chain per chunk])

    def _stripe(self, width):
        s = self.dep["storage_hosts"]
        start = self.cursor % len(s)
        self.cursor += 1
        return [s[(start + i) % len(s)] for i in range(min(width, len(s)))]

    def _chain(self, primary, r):
        s = self.dep["storage_hosts"]
        i = s.index(primary)
        return [s[(i + k) % len(s)] for k in range(min(r, len(s)))]

    def place(self, name, size, writer, attr):
        dep = self.dep
        attr = attr or {}
        policy = attr.get("placement") or dep["placement"]
        repl = attr.get("replication") or dep["replication"]
        n_chunks = -(-size // dep["chunk_size"])
        if policy == "local" and writer in dep["storage_hosts"]:
            targets = [writer] * n_chunks
        elif policy == "collocate":
            group = attr.get("group") or name
            if group not in self.targets:
                self.targets[group] = self._stripe(1)[0]
            targets = [self.targets[group]] * n_chunks
        else:                       # round_robin and broadcast stripe
            stripe = self._stripe(min(dep["stripe_width"],
                                      len(dep["storage_hosts"])))
            targets = [stripe[j % len(stripe)] for j in range(n_chunks)]
        chains = [self._chain(t, repl) for t in targets]
        self.files[name] = (size, chains)
        return size, chains

    def single_host(self, name):
        hosts = {c[0] for c in self.files[name][1]}
        return hosts.pop() if len(hosts) == 1 else None


def _chunk_bytes(size, chunk, n_chunks, j):
    return chunk if j < n_chunks - 1 else max(size - (n_chunks - 1) * chunk, 0)


class _Ops:
    def __init__(self, dep):
        self.dep = dep
        self.H = dep["n_hosts"]
        self.S = len(dep["storage_hosts"])
        self.sidx = {h: i for i, h in enumerate(dep["storage_hosts"])}
        self.cols = ([], [], [], [], [], [], [])   # res cls nbytes reqs extra nlat deps

    def op(self, res, cls, deps, nbytes=0.0, reqs=0.0, extra=0.0, nlat=0.0):
        deps = [d for d in deps if d >= 0]
        if len(deps) > MAXD:
            deps = [self.barrier(deps)]
        res_, cls_, nb_, rq_, ex_, nl_, dp_ = self.cols
        i = len(res_)
        res_.append(res)
        cls_.append(cls)
        nb_.append(float(nbytes))
        rq_.append(float(reqs))
        ex_.append(float(extra))
        nl_.append(float(nlat))
        dp_.append(deps + [-1] * (MAXD - len(deps)))
        return i

    def barrier(self, deps):
        deps = list(deps) or [-1]
        while len(deps) > MAXD:
            nxt = []
            for k in range(0, len(deps), MAXD):
                grp = deps[k:k + MAXD]
                nxt.append(self.op(0, NONE, grp) if len(grp) > 1 else grp[0])
            deps = nxt
        return self.op(0, NONE, deps)

    def hop(self, src, dst, nbytes, deps):
        H = self.H
        if src == dst:
            return self.op(1 + 2 * H + src, NET_LOCAL, deps, nbytes=nbytes,
                           nlat=1.0)
        a = self.op(1 + src, NET_REMOTE, deps, nbytes=nbytes)
        return self.op(1 + H + dst, NET_REMOTE, [a], nbytes=nbytes, nlat=1.0)

    def store(self, host):
        return 1 + 4 * self.H + self.sidx[host]

    @property
    def manager(self):
        return 1 + 4 * self.H + self.S

    def ask_manager(self, client, deps):
        m = self.dep["manager_host"]
        a = self.hop(client, m, CTRL_BYTES, deps)
        b = self.op(self.manager, MANAGER, [a], reqs=1.0)
        return self.hop(m, client, CTRL_BYTES, [b])

    def write(self, client, size, chains, deps):
        reply = self.ask_manager(client, deps)
        n, ck = len(chains), self.dep["chunk_size"]
        done = []
        for j, chain in enumerate(chains):
            cb = _chunk_bytes(size, ck, n, j)
            d = self.hop(client, chain[0], cb, [reply])
            d = self.op(self.store(chain[0]), STORAGE, [d], nbytes=cb, reqs=1.0)
            for prev, nxt in zip(chain, chain[1:]):
                d = self.hop(prev, nxt, cb, [d])
                d = self.op(self.store(nxt), STORAGE, [d], nbytes=cb, reqs=1.0)
            done.append(d)
        all_chunks = self.barrier(done)
        return self.ask_manager(client, [all_chunks])      # chunk-map commit

    def read(self, client, size, chains, deps):
        reply = self.ask_manager(client, deps)
        n, ck = len(chains), self.dep["chunk_size"]
        done = []
        for j, chain in enumerate(chains):
            cb = _chunk_bytes(size, ck, n, j)
            src = chain[j % len(chain)]               # replica j mod r
            d = self.hop(client, src, CTRL_BYTES, [reply])
            d = self.op(self.store(src), STORAGE, [d], nbytes=cb, reqs=1.0)
            done.append(self.hop(src, client, cb, [d]))
        return self.barrier(done)


def compile_dag(wf, dep, *, locality_aware=True):
    """The DAG as a dict of NumPy arrays (``res``, ``cls``, ``nbytes``,
    ``reqs``, ``extra``, ``nlat``, ``deps``) plus ``n_resources``."""
    mgr = _Manager(dep)
    b = _Ops(dep)
    for name, size, attr in wf["preloaded"]:
        mgr.place(name, size, dep["manager_host"], attr)
    written = {name: -1 for name, _, _ in wf["preloaded"]}
    clients = dep["client_hosts"]
    client_of_host = {h: i for i, h in enumerate(clients)}
    load = [0] * len(clients)
    last_on = {}
    for t in wf["tasks"]:
        c = t["client"]
        if c is None:
            if locality_aware and t["inputs"]:
                hosts = {mgr.single_host(f) for f in t["inputs"]}
                if len(hosts) == 1 and None not in hosts:
                    c = client_of_host.get(hosts.pop())
            if c is None:
                c = min(range(len(clients)), key=lambda k: (load[k], k))
        load[c] += 1
        host = clients[c]
        start_deps = [written[f] for f in t["inputs"]]
        if c in last_on:
            start_deps.append(last_on[c])
        start = b.barrier(start_deps)
        reads = [b.read(host, *mgr.files[f], [start]) for f in t["inputs"]]
        ready = b.barrier(reads) if reads else start
        comp = b.op(1 + 3 * b.H + host, CPU, [ready], extra=t["runtime"])
        ends = []
        for name, size in t["outputs"]:
            size, chains = mgr.place(name, size, host, t["attrs"].get(name))
            w = b.write(host, size, chains, [comp])
            written[name] = w
            ends.append(w)
        last_on[c] = b.barrier(ends + [comp])
    res, cls, nbytes, reqs, extra, nlat, deps = b.cols
    return {"res": np.asarray(res, dtype=np.int32),
            "cls": np.asarray(cls, dtype=np.int8),
            "nbytes": np.asarray(nbytes, dtype=np.float64),
            "reqs": np.asarray(reqs, dtype=np.float64),
            "extra": np.asarray(extra, dtype=np.float64),
            "nlat": np.asarray(nlat, dtype=np.float64),
            "deps": np.asarray(deps, dtype=np.int32).reshape(-1, MAXD),
            "n_resources": 1 + 4 * b.H + b.S + 1}
