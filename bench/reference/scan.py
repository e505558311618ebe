"""Scan-mode makespans of a compiled DAG, op by op in Python floats.

The predictor's fast mode freezes one serving order per DAG: each op's
start with every queue empty under a reference profile, sorted stably
(ties by op id). Every profile is then simulated in that order: an op
starts when its dependencies have completed (a dependency not yet served
reads 0.0) and its resource is free; the resource is busy for the op's
duration, and the op completes a network lag later. The makespan is the
latest time a resource is freed.

Durations: ``nbytes * byte_rate[cls] + reqs * request_rate[cls] +
extra``, lag ``nlat * net_latency``, in this order of operations.
A profile is a dict with the keys of `PROFILE_KEYS`, in seconds per byte
(``net_remote``, ``net_local``, ``storage``), seconds per request
(``manager``, ``client``, ``storage_req``) and seconds (``net_latency``).

`makespans` runs the same recurrence for many profiles at once: the ops
one by one in Python, each over a NumPy vector of profiles, with the
same f64 operations in the same order, so each makespan is the one
`makespan` gives for that profile, to the bit.
"""
from __future__ import annotations

import numpy as np

from .compiler import CLIENT, MANAGER, NET_LOCAL, NET_REMOTE, STORAGE

PROFILE_KEYS = ("net_remote", "net_local", "net_latency", "storage",
                "manager", "client", "storage_req")


def rates(p):
    """Byte and request rates per service class."""
    brate = [0.0] * 7
    rrate = [0.0] * 7
    brate[NET_REMOTE] = p["net_remote"]
    brate[NET_LOCAL] = p["net_local"]
    brate[STORAGE] = p["storage"]
    rrate[MANAGER] = p["manager"]
    rrate[CLIENT] = p["client"]
    rrate[STORAGE] = p["storage_req"]
    return brate, rrate


def durations(dag, p):
    """Per-op service durations and lags as lists of floats."""
    brate, rrate = rates(p)
    lat = p["net_latency"]
    dur = [nb * brate[c] + rq * rrate[c] + ex for c, nb, rq, ex in
           zip(dag["cls"].tolist(), dag["nbytes"].tolist(),
               dag["reqs"].tolist(), dag["extra"].tolist())]
    lag = [nl * lat for nl in dag["nlat"].tolist()]
    return dur, lag


def _deps(dag):
    return [tuple(d for d in row if d >= 0) for row in dag["deps"].tolist()]


def serving_order(dag, p_ref, deps=None):
    """Op ids sorted by contention-free start under ``p_ref``."""
    dur, lag = durations(dag, p_ref)
    deps = _deps(dag) if deps is None else deps
    n = len(dur)
    end = [0.0] * n
    start = [0.0] * n
    for i in range(n):
        s = 0.0
        for d in deps[i]:
            if end[d] > s:
                s = end[d]
        start[i] = s
        end[i] = s + (dur[i] + lag[i])
    return np.argsort(np.asarray(start), kind="stable").tolist()


def makespan(dag, order, p, deps=None):
    """The makespan of profile ``p`` with ops served in ``order``."""
    dur, lag = durations(dag, p)
    deps = _deps(dag) if deps is None else deps
    res = dag["res"].tolist()
    avail = [0.0] * dag["n_resources"]
    end = [0.0] * len(dur)
    mk = 0.0
    for i in order:
        ready = 0.0
        for d in deps[i]:
            if end[d] > ready:
                ready = end[d]
        r = res[i]
        start = ready if ready > avail[r] else avail[r]
        fin = start + dur[i]
        avail[r] = fin
        end[i] = fin + lag[i]
        if fin > mk:
            mk = fin
    return mk


def class_rates(vecs):
    """``[7, P]`` byte and request rates per service class and the
    ``[P]`` latencies of ``[P, 7]`` profiles in `PROFILE_KEYS` order."""
    col = dict(zip(PROFILE_KEYS, np.asarray(vecs, dtype=np.float64).T))
    brate = np.zeros((7, len(col["storage"])))
    rrate = np.zeros_like(brate)
    brate[NET_REMOTE] = col["net_remote"]
    brate[NET_LOCAL] = col["net_local"]
    brate[STORAGE] = col["storage"]
    rrate[MANAGER] = col["manager"]
    rrate[CLIENT] = col["client"]
    rrate[STORAGE] = col["storage_req"]
    return brate, rrate, col["net_latency"]


def makespans(dag, order, vecs, deps=None, block=1024):
    """The makespans of ``[P, 7]`` profiles ``vecs`` (`PROFILE_KEYS`
    order) with ops served in ``order``, as ``[P]`` f64. An op's
    completion is kept only until its last dependent has been served."""
    brate, rrate, lat = class_rates(vecs)
    deps = _deps(dag) if deps is None else deps
    order = list(order)
    last = {}
    for t, i in enumerate(order):
        for d in deps[i]:
            last[d] = t
    drop = {}
    for d, t in last.items():
        drop.setdefault(t, []).append(d)
    res = dag["res"].tolist()
    nlat = dag["nlat"].tolist()
    zero = np.zeros(brate.shape[1])
    avail = [zero] * dag["n_resources"]
    end = {}
    mk = zero.copy()
    for a in range(0, len(order), block):
        idx = np.asarray(order[a:a + block])
        c = dag["cls"][idx]
        dur = (dag["nbytes"][idx, None] * brate[c]
               + dag["reqs"][idx, None] * rrate[c] + dag["extra"][idx, None])
        for j, i in enumerate(idx.tolist()):
            ready = zero
            for d in deps[i]:
                ready = np.maximum(ready, end[d])
            r = res[i]
            fin = np.maximum(ready, avail[r]) + dur[j]
            avail[r] = fin
            if i in last:
                end[i] = fin + nlat[i] * lat
            np.maximum(mk, fin, out=mk)
            for d in drop.get(a + j, ()):
                del end[d]
    return mk


class Dag:
    """One compiled DAG with its serving order, ready to simulate any
    number of profiles."""

    def __init__(self, dag, p_ref):
        self.dag = dag
        self.deps = _deps(dag)
        self.order = serving_order(dag, p_ref, self.deps)

    @property
    def n_ops(self):
        return len(self.deps)

    def makespan(self, p):
        return makespan(self.dag, self.order, p, self.deps)

    def makespans(self, vecs):
        return makespans(self.dag, self.order, vecs, self.deps)
