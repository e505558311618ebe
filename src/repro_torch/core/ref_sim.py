"""Reference discrete-event simulator for the queue-based model (§2.3).

Exact DES semantics over the compiled micro-op DAG: every resource is a
single-server FIFO queue; an op becomes *ready* when all its predecessors
have completed (plus any network propagation lag); ready ops are served
in ready-time order (ties broken by op id, i.e. emission order — the
deterministic analogue of the paper's event-queue ordering).

This is the paper-faithful predictor and the oracle against which the
vectorized PyTorch simulator (`torch_sim`) is validated.
"""
from __future__ import annotations

import heapq
from typing import Dict, Optional

import numpy as np

from .compile import (CLS_CLIENT, CLS_CPU, CLS_MANAGER, CLS_NET_LOCAL,
                      CLS_NET_REMOTE, CLS_NONE, CLS_STORAGE, MAXD, N_CLS,
                      MicroOps)
from .faults import DEAD_TIME
from .types import RunReport, ServiceTimes


def rate_tables(st: ServiceTimes) -> tuple[np.ndarray, np.ndarray]:
    """(byte-rate per class, request-rate per class) — shared with torch_sim."""
    brate = np.zeros(N_CLS)
    rrate = np.zeros(N_CLS)
    brate[CLS_NET_REMOTE] = st.net_remote
    brate[CLS_NET_LOCAL] = st.net_local
    brate[CLS_STORAGE] = st.storage
    rrate[CLS_MANAGER] = st.manager
    rrate[CLS_CLIENT] = st.client
    rrate[CLS_STORAGE] = st.storage_req
    return brate, rrate


def durations(ops: MicroOps, st: ServiceTimes) -> np.ndarray:
    """Per-op service durations, fault-adjusted exactly like
    `torch_sim._durations`: degraded/straggler resources multiply their
    service time, unservable ops cost `faults.DEAD_TIME` seconds."""
    brate, rrate = rate_tables(st)
    dur = (ops.nbytes * brate[ops.cls] + ops.reqs * rrate[ops.cls] + ops.extra)
    if ops.res_mult is not None:
        dur = dur * ops.res_mult[ops.res]
    if ops.dead is not None:
        dur = dur + ops.dead * DEAD_TIME
    return dur


def simulate(ops: MicroOps, st: ServiceTimes) -> RunReport:
    n = ops.n_ops
    dur = durations(ops, st)
    lag = ops.nlat * st.net_latency
    deps = ops.deps
    res = ops.res

    # build children lists + indegree
    indeg = np.zeros(n, dtype=np.int32)
    children: list[list[int]] = [[] for _ in range(n)]
    for i in range(n):
        for d in deps[i]:
            if d >= 0:
                indeg[i] += 1
                children[d].append(i)

    end = np.zeros(n)            # completion as seen by dependents (incl. lag)
    ready_t = np.zeros(n)        # max end over scheduled deps
    avail = np.zeros(ops.n_resources)
    heap = [(0.0, i) for i in range(n) if indeg[i] == 0]
    heapq.heapify(heap)
    n_done = 0
    makespan = 0.0
    while heap:
        t, i = heapq.heappop(heap)
        start = max(t, avail[res[i]])
        fin = start + dur[i]
        avail[res[i]] = fin
        end[i] = fin + lag[i]
        makespan = max(makespan, fin)
        n_done += 1
        for c in children[i]:
            ready_t[c] = max(ready_t[c], end[i])
            indeg[c] -= 1
            if indeg[c] == 0:
                heapq.heappush(heap, (ready_t[c], c))
    assert n_done == n, f"cycle or dangling deps: {n_done}/{n}"

    per_task = {tid: float(end[op]) for tid, op in ops.task_end_op.items()}
    per_stage: Dict[str, float] = {}
    for tid, t_end in per_task.items():
        s = ops.stage_of_task.get(tid, "")
        per_stage[s] = max(per_stage.get(s, 0.0), t_end)
    return RunReport(makespan=float(makespan), bytes_moved=ops.bytes_moved,
                     storage_used=ops.storage_used, per_task_end=per_task,
                     per_stage_end=per_stage, n_events=n)
