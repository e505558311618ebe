"""The bad-day and the warm-tenants cells at a CPU's size, added as data
beside the drivers, readers and limits of `blast-s1-failures.faultjobs`
and `blast-s1.tenants`: correct as they stand; not correct under the f32
control and under the faults their checks are there to catch (a failover
that ignores the slow disk, a node lost one placement late, a tenant
answered for another subset). And the fault path's readers, on hand-made
spans and on a program that records no fault flag (the parent's)."""
from __future__ import annotations

import asyncio
import dataclasses
import json

import pytest
from conftest import ROOT, TINY_BLAST, make_checkout

from bench.benchkit import cell, spec
from bench.benchkit.cell import RunInfo
from bench.benchkit.spec import load_module
from repro_torch.obs.trace import Span

SEED = 2**31 + 5303
FAULTJOBS = "tiny-failures.tiny-faultjobs"
TENANTS = "tiny-blast.tiny-tenants"
FAULT_METRICS = {"faulted_compile_share.faultjobs",
                 "faulted_compile_us_per_op.faultjobs",
                 "faulted_prep_share.faultjobs"}

TINY_FAILURES = dict(
    json.loads((ROOT / "bench" / "configs" / "blast-s1-failures.json")
               .read_text()),
    name="tiny-failures", source="a small BLAST on a bad day for the CPU tests",
    cluster={"layout": "partitioned", "n_nodes": 8, "manager_nodes": 1},
    workflow={"pattern": "blast",
              "args": {"db_mb": 8, "per_query_s": 4.0, "query_mb": 1,
                       "out_mb": 2}},
    reduced=["db_mb", "n_nodes"])
TINY_FAULTJOBS = {
    "driver": "advisor_faults", "loop": "closed", "clients": 2,
    "request": {"n_queries": {"permutation": [5, 60]},
                "n_app": {"repeat": [3, 1, 4, 2]}},
    "candidates": {"chunk_sizes": [1048576, 4194304], "stripe_widths": [0]},
    "verify_top_k": 0, "objective": "makespan",
    "warmup": [{"n_queries": 3, "n_app": 2}],
    "check": {"answers": 3, "longest_by": "n_app"},
}
TINY_TENANTS_BLAST = dict(TINY_BLAST, workflow={
    "pattern": "blast", "args": {"db_mb": 12, "per_query_s": 4.0,
                                 "query_mb": 1, "out_mb": 2}})
# n_app 1-3 keep 4-2 storage nodes: 6 candidates, 62 subsets each; n_app
# 4 keeps 1: stripes 0 and 1, 4 candidates, 14 subsets
TINY_TENANTS = {
    "driver": "advisor_warm", "loop": "closed", "clients": 3,
    "request": {"n_queries": {"fixed": 12},
                "question": {"permutation": [0, 3 * 62 + 14 - 1]}},
    "partitions": [1, 2, 3, 4],
    "candidates": {"chunk_sizes": [1048576, 4194304],
                   "stripe_widths": [0, 1, 2]},
    "verify_top_k": 0, "objective": "makespan",
    "check": {"answers": 3, "longest_by": "n_app"},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with the tiny cells of `conftest` and these two."""
    dst = make_checkout(tmp_path_factory.mktemp("checkout"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    st = json.loads((ROOT / "bench" / "configs" / "blast-s1.json")
                    .read_text())["service_times"]
    for cfg, mix, lim_of, traffic in (
            (TINY_FAILURES, TINY_FAULTJOBS, "blast-s1-failures.faultjobs",
             "tiny-faultjobs"),
            (TINY_TENANTS_BLAST, TINY_TENANTS, "blast-s1.tenants",
             "tiny-tenants")):
        (dst / "bench" / "configs" / f"{cfg['name']}-{traffic}.json"
         ).write_text(json.dumps(dict(cfg, service_times=st)))
        (dst / "bench" / "mixes" / f"{traffic}.json").write_text(
            json.dumps(mix))
        wl = f"{cfg['name']}.{traffic}"
        (dst / "bench" / "limits" / f"{wl}.json").write_text(
            (ROOT / "bench" / "limits" / f"{lim_of}.json").read_text())
        name = f"{cfg['name']}-{traffic}"
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": f"bench/configs/{name}.json",
                                 "reduced": cfg["reduced"], "why": "CPU tests"})
        bench["workloads"].append({"name": wl, "config": name,
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if lim_of in m.get("workloads", ()):
                m["workloads"].append(wl)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


def _run(root, wl, trace=False, seconds=1.0, seed=SEED):
    return cell.run_cell(wl, seed, seconds, trace, root=root, device="cpu")


@pytest.mark.parametrize("wl", [FAULTJOBS, TENANTS])
def test_tiny_cell_is_correct(root, wl):
    out = _run(root, wl)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert {"setup_s", "predictions_per_s"} <= set(out["metrics"])
    if wl == FAULTJOBS:
        assert out["checks"]["failed_mismatches"]["value"] == 0


def test_faultjobs_kill_fires_in_every_job(root):
    """Every replication-1 faulted candidate is failed, every
    replication-2 one served; the healthy ones are all served."""
    c = spec.load_cell(root, FAULTJOBS)
    drv = c.driver_module().Driver(c, SEED, "cpu", None)

    async def ask():
        await drv.setup()
        try:
            return [await drv.issue(k, 0) for k in range(4)]
        finally:
            await drv.close()
    for _, (p, answer) in asyncio.run(ask()):
        for a in answer:
            r, faulted, failed = a[4], a[5], a[-1] >= 1e29
            assert failed == (faulted and r == 1), (p, a)


def test_traced_faultjobs_reads_the_fault_spans(root):
    out = _run(root, FAULTJOBS, trace=True)
    assert out["correct"] is True, out["checks"]
    m = out["metrics"]
    assert set(m) == FAULT_METRICS           # no card: no device metrics
    assert 0.0 < m["faulted_compile_share.faultjobs"]["value"] < 100.0
    assert 0.0 < m["faulted_prep_share.faultjobs"]["value"] < 100.0
    assert m["faulted_compile_us_per_op.faultjobs"]["value"] > 0.0


def test_f32_control_is_not_correct(root, monkeypatch):
    monkeypatch.setenv("REPRO_SIM_X64", "0")
    for wl in (FAULTJOBS, TENANTS):
        out = _run(root, wl)
        assert out["correct"] is False, wl
        assert out["checks"]["makespan_rel_gap"]["value"] > \
            out["checks"]["makespan_rel_gap"]["limit"]


def test_failover_that_ignores_the_slow_disk_is_not_correct(root,
                                                              monkeypatch):
    from repro_torch.core import placement
    pick = placement.Manager.pick_replica

    def blind(self, chain, j, degraded=None):
        return pick(self, chain, j, None)
    monkeypatch.setattr(placement.Manager, "pick_replica", blind)
    out = _run(root, FAULTJOBS)
    assert out["correct"] is False, out["checks"]


def test_node_lost_one_placement_late_is_not_correct(root, monkeypatch):
    from repro_torch.core.sweep import compilecache
    compile_workflow = compilecache.compile_workflow

    def late(wf, cfg, **kw):
        if cfg.faults is not None:
            f = cfg.faults
            cfg = dataclasses.replace(cfg, faults=dataclasses.replace(
                f, failures=tuple(dataclasses.replace(
                    x, after_tasks=x.after_tasks + 1) for x in f.failures)))
        return compile_workflow(wf, cfg, **kw)
    monkeypatch.setattr(compilecache, "compile_workflow", late)
    out = _run(root, FAULTJOBS)
    assert out["correct"] is False, out["checks"]


def test_tenant_answered_for_another_subset_is_not_correct(root, monkeypatch):
    from repro_torch.serve import server
    sweep = server.AdvisorServer._run_sweep

    def short(self, req):
        if len(req.candidates) > 1:
            req = dataclasses.replace(req, candidates=req.candidates[:-1])
        return sweep(self, req)
    monkeypatch.setattr(server.AdvisorServer, "_run_sweep", short)
    out = _run(root, TENANTS)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["wrong_answers"]["value"] > 0


def reader(name):
    return load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                       name.replace(".", "_"))


def span(name, start, dur, **meta):
    return Span(name, start, dur, meta=tuple(sorted(meta.items())))


def info(spans, window_s=10.0):
    return RunInfo(cell=None, setup_s=1.0, window_s=window_s, records=[],
                   program_spans=spans)


def test_fault_readers_clip_to_the_window_and_read_the_flag():
    spans = [
        span("compile_dag", -1.0, 2.0, ops=1000, faulted=1),   # half inside
        span("compile_dag", 2.0, 3.0, ops=9000, faulted=0),
        span("compile_dag", 5.0, 2.0, ops=4000, faulted=1),
        span("compile_dag", 9.0, 2.0, ops=2000, faulted=1),    # half inside
        span("prep[8x4]", 1.0, 1.5, rows=3, faulted=1),
        span("prep[8x4]", 3.0, 1.0, rows=3, faulted=0),
        span("prep[16x4]", 9.5, 1.0, rows=1, faulted=1),       # half inside
    ]
    share = reader("faulted_compile_share.faultjobs").read
    rate = reader("faulted_compile_us_per_op.faultjobs").read
    prep = reader("faulted_prep_share.faultjobs").read
    assert share(info(spans)) == pytest.approx(100.0 * 4.0 / 10.0)
    assert rate(info(spans)) == pytest.approx(1e6 * 4.0 / (500 + 4000 + 1000))
    assert prep(info(spans)) == pytest.approx(100.0 * 2.0 / 10.0)


def test_fault_readers_read_nothing_without_the_flag():
    """The parent's spans carry no ``faulted``: each reader returns None."""
    spans = [span("compile_dag", 1.0, 2.0, ops=1000, bulk_ops=900, tasks=3),
             span("prep[8x4]", 3.0, 1.0, rows=3),
             span("compile_grid", 0.5, 3.0)]
    for name in FAULT_METRICS:
        assert reader(name).read(info(spans)) is None
        assert reader(name).read(info([])) is None
