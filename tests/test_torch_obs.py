"""The port's observability layer (`repro_torch.obs`: `timeline`,
`export`) against the reference's (`repro.obs`), on the CPU.

Timelines: the same DAG simulated by both packages with
``timeline=True`` gives, in scan mode, `np.array_equal` start / dur /
lag / end arrays (the scan's ``end`` is element-wise equal, and dur /
lag / start are the same host-side f64 arithmetic in the same order),
and in exact mode agreement at ``rtol=1e-12`` (the bound exact mode is
held to), healthy and faulted. The critical path is the same op chain
and its duration equals the makespan (``rel=1e-9``, the reference's own
bound). `explore(timeline_top_k=2)` attaches equal timelines to the same
two best candidates. Export: the event structure of
`spans_to_events` / `timeline_to_events`, `write_trace`, and a
`metrics_snapshot` that covers every declared counter field.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import jax_sim
from repro.core import workloads as JW
from repro.obs import timeline_to_events as j_timeline_to_events

import repro_torch.core as T
from repro_torch.core import torch_sim
from repro_torch.core import workloads as TW
from repro_torch.core.compile import (CLS_CLIENT, CLS_CPU, CLS_MANAGER,
                                      CLS_NET_LOCAL, CLS_NET_REMOTE, CLS_NONE,
                                      CLS_STORAGE, compile_count)
from repro_torch.core.sweep.compilecache import CompileCacheStats
from repro_torch.core.sweep.engine import CacheStats
from repro_torch.obs import (Timeline, Tracer, metrics_snapshot,
                             resource_names, spans_to_events, stats_snapshot,
                             timeline_to_events, write_trace)
from repro_torch.obs.export import CLASS_NAMES
from repro_torch.serve import ResultsCacheStats, ServeStats

torch.set_num_threads(1)

FAULT = "disk=0:8,slow=1:2"
ARRAYS = ("start", "dur", "lag", "end")


def compiled_pair(name, faults):
    """The same DAG compiled by both packages on a 5-host collocated
    cluster, healthy or under a degraded disk and a straggler."""
    jcfg = J.collocated_config(5, chunk_size=256 * 1024,
                               faults=J.parse_faults(faults) if faults else None)
    tcfg = T.collocated_config(5, chunk_size=256 * 1024,
                               faults=T.parse_faults(faults) if faults else None)
    make = {"pipeline": lambda W: W.pipeline(4, stage_mb=(4, 8, 4, 1)),
            "broadcast": lambda W: W.broadcast(3, file_mb=4, replication=2),
            "blast": lambda W: W.blast(4, n_queries=8, db_mb=16)}[name]
    return (J.compile_workflow(make(JW), jcfg),
            T.compile_workflow(make(TW), tcfg))


@pytest.mark.parametrize("faults", [None, FAULT])
@pytest.mark.parametrize("name", ["pipeline", "broadcast", "blast"])
@pytest.mark.parametrize("exact", [False, True])
def test_timeline_equals_reference(exact, name, faults):
    jo, to = compiled_pair(name, faults)
    rj = jax_sim.simulate(jo, J.PAPER_RAMDISK, exact=exact, timeline=True)
    rt = torch_sim.simulate(to, T.PAPER_RAMDISK, exact=exact, timeline=True,
                            device="cpu")
    tj, tt = rj.timeline, rt.timeline
    assert isinstance(tt, Timeline) and tt.n_ops == tj.n_ops == to.n_ops
    assert tt.n_resources == tj.n_resources
    for name_ in ("res", "cls", "deps"):
        np.testing.assert_array_equal(getattr(tt, name_), getattr(tj, name_))
    if exact:
        for name_ in ARRAYS:
            np.testing.assert_allclose(getattr(tt, name_),
                                       getattr(tj, name_), rtol=1e-12,
                                       atol=1e-12 * tj.makespan)
        assert tt.makespan == pytest.approx(tj.makespan, rel=1e-12)
    else:
        for name_ in ARRAYS:
            np.testing.assert_array_equal(getattr(tt, name_),
                                          getattr(tj, name_))
        assert tt.makespan == tj.makespan
        assert tt.critical_path() == tj.critical_path()
    np.testing.assert_allclose(tt.busy_seconds(), tj.busy_seconds(),
                               rtol=1e-12)
    # the timeline explains the makespan
    assert tt.critical_path_duration() == pytest.approx(tt.makespan,
                                                        rel=1e-9)
    assert tt.critical_path_duration() == pytest.approx(rt.makespan,
                                                        rel=1e-9)
    assert float(tt.start[tt.critical_path()[0]]) <= tt._tol()
    u = tt.utilization()
    assert (u >= 0.0).all() and (u <= 1.0 + 1e-9).all()


def test_timeline_not_built_by_default():
    _, to = compiled_pair("pipeline", None)
    assert torch_sim.simulate(to, T.PAPER_RAMDISK, device="cpu").timeline \
        is None


def test_broken_chain_fails_loudly():
    _, to = compiled_pair("pipeline", None)
    tl = torch_sim.simulate(to, T.PAPER_RAMDISK, timeline=True,
                            device="cpu").timeline
    i = int(np.argmax(tl.fin))
    tl.start = tl.start.copy()
    tl.start[i] += 1.0          # no predecessor ends then: no chain
    with pytest.raises(ValueError, match="chain break"):
        tl.critical_path()


@pytest.mark.parametrize("verify_top_k", [0, 2])
def test_explore_timeline_top_k_parity(verify_top_k):
    def jwf(c):
        return JW.pipeline(c.n_app, stage_mb=(2, 2, 2, 1))

    def twf(c):
        return TW.pipeline(c.n_app, stage_mb=(2, 2, 2, 1))

    jc = J.grid(n_nodes=[6], chunk_sizes=[256 * 1024, 1 * J.MB])
    tc = T.grid(n_nodes=[6], chunk_sizes=[256 * 1024, 1 * T.MB])
    with J.SweepSession(J.InlineBackend()) as js:
        ej = J.explore(jwf, jc, J.PAPER_RAMDISK, verify_top_k=verify_top_k,
                       timeline_top_k=2, session=js)
    with T.SweepSession(T.InlineBackend(), device="cpu") as ts:
        et = T.explore(twf, tc, T.PAPER_RAMDISK, verify_top_k=verify_top_k,
                       timeline_top_k=2, session=ts)
        # the two re-simulations ran through the engine's dispatch: on a
        # CPU engine under "auto" each scan-mode one counts a fallback,
        # as the sweep's scan batch did (exact ones want no kernel)
        assert ts.stats.kernel_fallbacks == \
            1 + sum(not e.verified for e in et[:2])
        assert ts.stats.kernel_launches == 0
    assert [e.index for e in et] == [e.index for e in ej]
    assert [e.timeline is not None for e in et] == \
        [e.timeline is not None for e in ej] == \
        [True, True] + [False] * (len(et) - 2)
    for a, b in zip(ej[:2], et[:2]):
        assert b.timeline.makespan == pytest.approx(b.makespan, rel=1e-9)
        for name_ in ARRAYS:
            if a.verified:
                np.testing.assert_allclose(getattr(b.timeline, name_),
                                           getattr(a.timeline, name_),
                                           rtol=1e-12, atol=1e-15)
            else:
                np.testing.assert_array_equal(getattr(b.timeline, name_),
                                              getattr(a.timeline, name_))
        assert b.timeline.critical_path_duration() == pytest.approx(
            b.timeline.makespan, rel=1e-9)


# ---------------- export ----------------------------------------------------------

def test_class_names_pin_compile_constants():
    want = {CLS_NONE: "none", CLS_NET_REMOTE: "net_remote",
            CLS_NET_LOCAL: "net_local", CLS_STORAGE: "storage",
            CLS_MANAGER: "manager", CLS_CLIENT: "client", CLS_CPU: "cpu"}
    for idx, name in want.items():
        assert CLASS_NAMES[idx] == name


def test_resource_names_follow_resource_map():
    cfg = T.collocated_config(5, chunk_size=256 * 1024)
    ops = T.compile_workflow(TW.pipeline(2, stage_mb=(1, 1, 1, 1)), cfg)
    names = resource_names(cfg)
    assert len(names) == ops.n_resources
    assert names[0] == "dummy" and names[-1] == "manager"
    assert f"storage:h{cfg.storage_hosts[0]}" in names


def test_spans_to_events_structure():
    tr = Tracer()
    with tr.span("a", phase="compile", rows=2):
        pass
    tr.absorb([("b", 0.0, 0.1, "sim", ())], offset=1.0, track="w1")
    events = spans_to_events(tr.spans())
    xs = [e for e in events if e["ph"] == "X"]
    ms = [e for e in events if e["ph"] == "M"]
    assert len(xs) == 2 and ms
    assert {e["args"]["name"] for e in ms if e["name"] == "process_name"} \
        == {"host", "w1"}
    for e in xs:
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        assert e["dur"] >= 0.0 and e["ts"] >= 0.0
    assert len({e["pid"] for e in xs}) == 2
    assert {e["name"] for e in xs} == {"a", "b"}
    assert next(e for e in xs if e["name"] == "a")["args"] == {"rows": 2}


def test_timeline_to_events_equal_reference_and_write_trace(tmp_path):
    jo, to = compiled_pair("broadcast", None)
    cfg = T.collocated_config(5, chunk_size=256 * 1024)
    tl = torch_sim.simulate(to, T.PAPER_RAMDISK, timeline=True,
                            device="cpu").timeline
    tl.resource_names = tuple(resource_names(cfg))
    tj = jax_sim.simulate(jo, J.PAPER_RAMDISK, timeline=True).timeline
    tj.resource_names = tl.resource_names
    events = timeline_to_events(tl, label="sim")
    assert events == j_timeline_to_events(tj, label="sim")
    xs = [e for e in events if e["ph"] == "X"]
    assert xs, "no slices rendered"
    for e in xs:
        assert e["name"] in CLASS_NAMES
        assert 1 <= e["tid"] <= tl.n_resources
    # zero-duration barrier ops carry no time and are skipped
    assert len(xs) == int((tl.dur > 0).sum())
    path = write_trace(tmp_path / "t.json", events,
                       metrics={"k": np.int64(3)}, meta={"m": 1})
    doc = json.loads(path.read_text())
    assert doc["traceEvents"] and doc["otherData"]["metrics"]["k"] == 3
    assert doc["otherData"]["m"] == 1


@pytest.mark.parametrize("cls", [CacheStats, CompileCacheStats,
                                 ResultsCacheStats, ServeStats])
def test_stats_reset_covers_every_declared_field(cls):
    stats = cls()
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, dict):
            v["x"] = 7
        else:
            setattr(stats, f.name, 3)
    stats.reset()
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        assert v == {} if isinstance(v, dict) else v == 0, \
            f"{cls.__name__}.{f.name} survived reset(): {v!r}"


def test_metrics_snapshot_covers_every_declared_counter():
    with T.SweepSession(T.InlineBackend(), device="cpu") as sess:
        cands = T.grid(n_nodes=[6], chunk_sizes=[256 * 1024])
        T.explore(lambda c: TW.pipeline(c.n_app, stage_mb=(2, 2, 2, 1)),
                  cands, T.PAPER_RAMDISK, verify_top_k=1, session=sess)
        snap = metrics_snapshot(sess, extra={"generated_at": "now"})
    for f in dataclasses.fields(CacheStats):
        if f.default_factory is dataclasses.MISSING:     # not a dict rollup
            assert f"engine.{f.name}" in snap, f.name
    for f in dataclasses.fields(CompileCacheStats):
        if f.default_factory is dataclasses.MISSING:
            assert f"compile.{f.name}" in snap, f.name
    assert snap["engine.batch_calls"] >= 2      # scan + verify
    assert snap["engine.kernel_launches"] == 0
    assert snap["compile.grid_candidates"] == len(cands)
    assert snap["compile_count"] == compile_count()
    assert snap["generated_at"] == "now"
    sess.stats.worker_rows["w1"] = 5
    assert stats_snapshot(sess.stats, "engine.")["engine.worker_rows.w1"] == 5
