"""The port's fault path against the benchmark's plain reference of it
(`bench/reference/faults.py`: NumPy and Python only, written from the
documented semantics): small BLAST jobs under a storage node lost at
every placement index and a slow disk on each rank, compiled and
scanned on the CPU. The DAGs, the scan-mode makespans and the failed
verdicts are held to the bit; the compile's fault counters (the
``compile_dag`` span's meta) to hand counts; tracing changes nothing.

Imports no JAX: the reference is the benchmark's, which runs beside
the port on a machine without it.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import repro_torch.core as T  # noqa: E402
from repro_torch.core import faults as port_faults  # noqa: E402
from repro_torch.core import workloads as W  # noqa: E402
from repro_torch.core.sweep.compilecache import CompileCache  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402

from bench.reference import compiler as ref_compiler  # noqa: E402
from bench.reference import faults as ref_faults  # noqa: E402
from bench.reference.patterns import blast as ref_blast  # noqa: E402

torch.set_num_threads(1)

ST = T.PAPER_RAMDISK
P = dataclasses.asdict(ST)
KB = 1 << 10
JOB = dict(n_queries=13, db_mb=3, per_query_s=4.0, query_mb=1, out_mb=1)
CHUNKS = (256 * KB, 1024 * KB)
ARRAYS = ("res", "cls", "nbytes", "reqs", "extra", "nlat", "deps")


def n_storage_of(n_app):
    return max(2, 7 - n_app)


def port_scenario(kill=(), degraded=(), slow=()):
    return T.FaultScenario(
        failures=tuple(T.NodeFailure(r, after_tasks=k) for r, k in kill),
        degraded=tuple(T.DiskDegradation(r, f) for r, f in degraded),
        stragglers=tuple(T.Straggler(r, f) for r, f in slow))


def ref_scenario(kill=(), degraded=(), slow=()):
    return {"kill": list(kill), "degraded": dict(degraded), "slow": dict(slow)}


def scenarios(n_app, n_storage, kind):
    """``kind`` "kill": storage rank 1 lost before each task in turn (and
    before anything is placed, and never), beside a disk 8x slow on rank
    0, then ranks 0 and 1 both lost; "disk": a disk 8x slow on each rank
    alone, and with rank 0 lost half-way and a client 3x slow."""
    half = n_app // 2
    out = []
    if kind == "kill":
        for k in [None, *range(n_app + 1)]:
            out.append(dict(kill=[(1, k)], degraded=[(0, 8.0)]))
            out.append(dict(kill=[(1, k), (0, half)]))
    else:
        for r in range(n_storage):
            out.append(dict(degraded=[(r, 8.0)]))
            out.append(dict(kill=[(0, half)], degraded=[(r, 5.5)],
                            slow=[(n_app - 1, 3.0)]))
    return out


def case(n_app, chunk, r, scen):
    n_storage = n_storage_of(n_app)
    cfg = T.partitioned_config(n_app, n_storage, chunk_size=chunk,
                               replication=r, faults=port_scenario(**scen))
    counts = {}
    ops = T.compile_workflow(W.blast(n_app, **JOB), cfg, counts=counts)
    dep = ref_compiler.partitioned(n_app, n_storage, chunk_size=chunk,
                                   replication=r)
    ref = ref_faults.compile_dag(ref_blast.build(n_app, **JOB), dep,
                                 ref_scenario(**scen))
    return ops, counts, ref


def port_makespans(ops_list):
    """Scan-mode makespans through the engine's buckets, as a sweep
    runs them (faulted buckets with their fault arrays)."""
    eng = T.SweepEngine(device="cpu")
    return eng.simulate_batch(ops_list, [ST] * len(ops_list))


@pytest.mark.parametrize("kind", ["kill", "disk"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("n_app", [2, 3, 4, 5, 6])
def test_faulted_blast_equals_the_reference(n_app, r, kind):
    cases = [case(n_app, ck, r, s) for ck in CHUNKS
             for s in scenarios(n_app, n_storage_of(n_app), kind)]
    for ops, counts, ref in cases:
        for f in ARRAYS:
            np.testing.assert_array_equal(getattr(ops, f), ref[f], err_msg=f)
        assert ops.n_resources == ref["n_resources"]
        dead = np.zeros(ops.n_ops) if ops.dead is None else ops.dead
        mult = (np.ones(ops.n_resources) if ops.res_mult is None
                else ops.res_mult)
        np.testing.assert_array_equal(dead, ref["dead"])
        np.testing.assert_array_equal(mult, ref["mult"])
        assert {k: counts[k] for k in ref["counts"]} == ref["counts"]
        assert counts["faulted"] == 1
    got = port_makespans([ops for ops, _, _ in cases])
    want = np.array([ref_faults.Dag(ref, P).makespan(P)
                     for _, _, ref in cases])
    np.testing.assert_array_equal(got, want)
    assert [port_faults.failed(m) for m in got] == \
        [ref_faults.failed(m) for m in want]
    if kind == "kill":           # both verdicts occur
        assert any(ref_faults.failed(m) for m in want)
        assert not all(ref_faults.failed(m) for m in want)


# the job of the hand counts: 2 app nodes, storage s0 and s1; the 1 MB
# database at 256 KB is 4 chunks, each query file 4, each result 4
HAND_JOB = dict(n_queries=4, db_mb=1, per_query_s=1.0, query_mb=1, out_mb=1)


@pytest.mark.parametrize("r,want", [
    # r 1: task 0 reads db and queries0 (8 picks, each its one replica);
    # s1 dies before task 1, whose db and queries1 lose their 2 chunks
    # on s1 each (8 picks, 4 dead ops)
    (1, dict(faulted=1, picks=16, failovers=0, dead_ops=4, kills=1)),
    # r 2: task 0's db chunks all default to s0 (chain [s0, s1] read at
    # j mod 2 = 0, or [s1, s0] at 1) and fail over to s1, the healthy
    # disk: 4 failovers; queries0's default to s1 already; task 1 finds
    # s1 dead, and each default replica is the s0 that is left
    (2, dict(faulted=1, picks=16, failovers=4, dead_ops=0, kills=1)),
])
def test_compile_dag_counts_equal_hand_counts(r, want):
    scen = T.FaultScenario(failures=(T.NodeFailure(1, after_tasks=1),),
                           degraded=(T.DiskDegradation(0, 8.0),))
    healthy = T.Candidate(n_nodes=5, n_app=2, n_storage=2,
                          chunk_size=256 * KB, replication=r)
    tr = Tracer()
    CompileCache().compile_grid(
        lambda c: W.blast(2, **HAND_JOB),
        [healthy, dataclasses.replace(healthy, faults=scen)], tracer=tr)
    spans = [dict(s.meta) for s in tr.spans() if s.name == "compile_dag"]
    keys = ("faulted", "picks", "failovers", "dead_ops", "kills")
    assert [{k: m[k] for k in keys} for m in spans] == \
        [dict.fromkeys(keys, 0), want]
    ref = ref_faults.compile_dag(
        ref_blast.build(2, **HAND_JOB),
        ref_compiler.partitioned(2, 2, chunk_size=256 * KB, replication=r),
        ref_scenario(kill=[(1, 1)], degraded=[(0, 8.0)]))
    assert ref["counts"] == {k: want[k] for k in ref["counts"]}


def test_tracing_changes_no_makespan_and_flags_faulted_buckets():
    scen = port_scenario(kill=[(1, 2)], degraded=[(0, 8.0)])
    cands = T.grid(n_nodes=[8], partitions=[(4, 3)], chunk_sizes=CHUNKS,
                   replications=(1, 2), faults=(None, scen))
    wf = W.blast(4, **JOB)

    def run(tracer):
        sess = T.SweepSession(device="cpu", tracer=tracer)
        evals = T.explore(lambda c: wf, cands, ST, verify_top_k=0,
                          session=sess)
        return [(e.index, e.makespan, e.failed) for e in evals]

    tr = Tracer()
    traced = run(tr)
    assert traced == run(None)
    assert sum(f for _, _, f in traced) == 2          # r 1 under the kill
    dags = [dict(s.meta) for s in tr.spans() if s.name == "compile_dag"]
    assert sorted(m["faulted"] for m in dags) == [0] * 4 + [1] * 4
    assert all(m["kills"] == m["faulted"] for m in dags)
    preps = [dict(s.meta) for s in tr.spans() if s.name.startswith("prep[")]
    assert preps and {m["faulted"] for m in preps} <= {0, 1}
    assert any(m["faulted"] == 1 for m in preps)
