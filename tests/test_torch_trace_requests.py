"""Request-scoped spans of the port (`repro_torch.obs.trace`) where the
work happens: the advisor service's request, queue wait and sweep, one
``compile_dag`` span per cold DAG compile with its op count and how many
of them were emitted as blocks, the what-if path's four parts, and where
each cold row's estimated-start order was built. CPU,
but for one ``gpu`` case that counts the what-if path's kernel launches
on the card.

The file imports `repro_torch` only, so the ``gpu`` case runs on a
machine with a card: ``python -m pytest -q -m gpu
tests/test_torch_trace_requests.py``. With tracing off the answers, the
compile count and the engine's counters are those of an untraced run.
"""
import asyncio
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import torch_sim
from repro_torch.core import workloads as W
from repro_torch.core.compile import compile_count
from repro_torch.obs import NULL_TRACER, Tracer
from repro_torch.serve import AdvisorRequest, AdvisorServer

torch.set_num_threads(1)

ST = T.PAPER_RAMDISK
EPS = 1e-9          # spans on one clock, re-based by one subtraction
SWEEP_CHILDREN = ("compile_grid", "compile_dag", "simulate_batch")
WHAT_IF_PARTS = ("what_if.vectors", "what_if.scan_order", "what_if.arrays",
                 "what_if.scan")


def meta(s):
    return dict(s.meta)


def inside(child, parent):
    return parent.start - EPS <= child.start and child.end <= parent.end + EPS


def serve_grid():
    return T.grid(n_nodes=[7], partitions=[(2, 4)],
                  chunk_sizes=[512 * 1024, 1 * T.MB])


def question(n_queries, **kw):
    kw.setdefault("verify_top_k", 1)
    return AdvisorRequest(
        workflow=W.blast(2, n_queries=n_queries, db_mb=16, per_query_s=1.0),
        candidates=serve_grid(), **kw)


def serve(tracer, reqs, *, repeat_first=False, one_by_one=False):
    """Answer ``reqs`` concurrently (with ``one_by_one``, each after the
    one before has its answer) on a fresh CPU session, then (with
    ``repeat_first``) ask the first again; returns the responses, the
    compiles made, and the engine's and DAG cache's counters."""
    async def main():
        sess = T.SweepSession(T.InlineBackend(), device="cpu", tracer=tracer)
        async with AdvisorServer(ST, session=sess,
                                 batch_window_s=0.05) as srv:
            n0 = compile_count()
            if one_by_one:
                resps = [await srv.submit(r) for r in reqs]
            else:
                resps = list(await asyncio.gather(*(srv.submit(r)
                                                    for r in reqs)))
            if repeat_first:
                resps.append(await srv.submit(reqs[0]))
            stats = (dataclasses.asdict(sess.stats),
                     dataclasses.asdict(sess.compile_stats))
            return resps, compile_count() - n0, stats
    return asyncio.run(main())


# -- the tracer ----------------------------------------------------------------

def test_request_scope_tags_spans_of_its_thread():
    tr = Tracer()
    t0 = tr.clock()
    with tr.request(3):
        with tr.span("a"):
            pass
        with tr.request(4):
            tr.record("b", t0, tr.clock(), phase="p", k=1)
        with tr.span("c", req=9):            # its own id wins
            pass
        assert tr.current_request() == 3
        seen = []
        th = threading.Thread(target=lambda: seen.append(
            tr.current_request()))
        th.start()
        th.join(5)
        assert not th.is_alive() and seen == [None]
    with tr.span("d"):
        pass
    assert tr.current_request() is None
    by = {s.name: s for s in tr.spans()}
    assert meta(by["a"]) == {"req": 3}
    assert meta(by["b"]) == {"k": 1, "req": 4} and by["b"].phase == "p"
    assert by["b"].start == pytest.approx(t0 - tr._epoch, abs=EPS)
    assert meta(by["c"]) == {"req": 9}
    assert meta(by["d"]) == {}
    assert all(list(s.meta) == sorted(s.meta) for s in tr.spans())


def test_null_tracer_scope_is_the_shared_no_op():
    assert NULL_TRACER.request(1) is NULL_TRACER.span("x")
    with NULL_TRACER.request(1):
        assert NULL_TRACER.current_request() is None
        assert NULL_TRACER.record("x", 0.0, 1.0, req=1) is None
    assert NULL_TRACER.spans() == ()
    assert NULL_TRACER.clock is Tracer.clock
    assert not hasattr(Tracer, "tracks") and not hasattr(NULL_TRACER, "tracks")


def test_request_scopes_of_many_threads_do_not_mix():
    """More threads than cores, switching often: every span carries the
    id of the thread that recorded it."""
    tr = Tracer()
    n_threads, n_spans = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            with tr.request(i):
                for _ in range(n_spans):
                    with tr.span(f"t{i}"):
                        pass
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    spans = tr.spans()
    assert len(spans) == n_threads * n_spans
    assert all(s.name == f"t{meta(s)['req']}" for s in spans)


# -- the advisor service ---------------------------------------------------------

@pytest.mark.parametrize("batches", ["separate", "shared"])
def test_each_request_has_its_wait_and_sweep_under_one_id(batches):
    """Two distinct questions. Asked one after the other, each has its
    own wait and its own sweep of one question under its id. Asked at
    once, they land in one batch and share one engine call: one
    ``serve.sweep`` under the first ticket's id, with ``questions`` 2
    and the candidates summed; each ticket's wait ends before it starts,
    and the call's compile, prep and sim spans lie inside it."""
    tr = Tracer()
    resps, _, _ = serve(tr, [question(8, client="a"),
                             question(10, client="b")],
                        one_by_one=batches == "separate")
    assert not any(r.cached for r in resps)
    spans = tr.spans()
    assert all("req" in meta(s) for s in spans)
    rids = sorted({meta(s)["req"] for s in spans})
    assert rids == [1, 2]
    sweeps = [s for s in spans if s.name == "serve.sweep"]
    if batches == "separate":
        assert [meta(s) for s in sweeps] == [
            {"req": rid, "questions": 1, "candidates": 2, "group": 1}
            for rid in rids]
    else:
        assert [meta(s) for s in sweeps] == [
            {"req": 1, "questions": 2, "candidates": 4, "group": 2}]
    for rid, client in zip(rids, "ab"):
        mine = [s for s in spans if meta(s)["req"] == rid]
        (request,) = [s for s in mine if s.name == "serve.request"]
        (wait,) = [s for s in mine if s.name == "serve.wait"]
        (sweep,) = [s for s in sweeps if s.name == "serve.sweep"
                    and meta(s)["req"] == (rid if batches == "separate"
                                           else 1)]
        assert meta(request) == {"req": rid, "client": client,
                                 "cached": False, "group": 1}
        assert wait.start == pytest.approx(request.start, abs=EPS)
        assert wait.end <= sweep.start + EPS and inside(sweep, request)
        assert wait.dur + sweep.dur <= request.dur + EPS
    work = [s for s in spans if s.name in SWEEP_CHILDREN
            or s.name.startswith(("prep[", "sim["))]
    for sweep in sweeps:
        its = [s for s in work if meta(s)["req"] == meta(sweep)["req"]]
        names = {s.name.split("[")[0] for s in its}
        assert {"compile_grid", "compile_dag", "prep", "sim"} <= names
        assert all(inside(s, sweep) for s in its)
    assert {meta(s)["req"] for s in work} == {meta(s)["req"] for s in sweeps}


def test_coalesced_siblings_each_record_their_wait():
    tr = Tracer()
    resps, _, _ = serve(tr, [question(8, client=c) for c in "abc"])
    assert {r.group_size for r in resps} == {3}
    spans = tr.spans()
    waits = [s for s in spans if s.name == "serve.wait"]
    (sweep,) = [s for s in spans if s.name == "serve.sweep"]
    assert sorted(meta(w)["req"] for w in waits) == [1, 2, 3]
    assert all(w.end <= sweep.start + EPS for w in waits)
    assert meta(sweep)["group"] == 3


def test_results_cache_hit_records_a_wait_and_no_sweep():
    tr = Tracer()
    resps, _, _ = serve(tr, [question(8)], repeat_first=True)
    assert [r.cached for r in resps] == [False, True]
    mine = [s for s in tr.spans() if meta(s)["req"] == 2]
    assert sorted(s.name for s in mine) == ["serve.request", "serve.wait"]
    (request,) = [s for s in mine if s.name == "serve.request"]
    (wait,) = [s for s in mine if s.name == "serve.wait"]
    assert meta(request)["cached"] is True and inside(wait, request)


def test_tracing_off_changes_no_answer_and_no_counter():
    reqs = [question(8), question(10), question(8)]
    off, n_off, stats_off = serve(NULL_TRACER, reqs, repeat_first=True)
    on, n_on, stats_on = serve(Tracer(), reqs, repeat_first=True)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.makespans, b.makespans)
        assert (a.cached, a.group_size) == (b.cached, b.group_size)
    assert n_off == n_on > 0
    assert stats_off == stats_on


# -- host compile ----------------------------------------------------------------

@pytest.mark.parametrize("workers,enabled", [(None, True), (3, True),
                                             (None, False)])
def test_compile_dag_spans_count_the_compiled_ops(workers, enabled):
    tr = Tracer()
    cache = T.CompileCache(enabled=enabled)
    cands = T.grid(n_nodes=[7], partitions=[(2, 4), (3, 3)],
                   chunk_sizes=[512 * 1024, 1 * T.MB, 1 * T.MB])
    wf = {n: W.blast(n, n_queries=8, db_mb=16) for n in (2, 3)}
    n0 = compile_count()
    with tr.request(7):
        ops = cache.compile_grid(lambda c: wf[c.n_app], cands,
                                 workers=workers, tracer=tr)
    dags = [s for s in tr.spans() if s.name == "compile_dag"]
    assert len(dags) == compile_count() - n0 == cache.stats.misses > 0
    distinct = {id(o): o for o in ops}.values()
    assert sum(meta(s)["ops"] for s in dags) == \
        sum(o.n_ops for o in (ops if not enabled else distinct))
    assert all(meta(s)["req"] == 7 and s.phase == "compile" for s in dags)
    assert all(0 <= meta(s)["bulk_ops"] <= meta(s)["ops"] for s in dags)
    assert {meta(s)["tasks"] for s in dags} == \
        {len(w.tasks) for w in wf.values()}
    if enabled:                 # warm: nothing compiles, nothing recorded
        tr.clear()
        cache.compile_grid(lambda c: wf[c.n_app], cands, tracer=tr)
        assert tr.spans() == ()


def test_compile_dag_spans_count_the_ops_emitted_in_blocks():
    """A BLAST DAG is almost all database chunks: nearly every op comes
    from the block emitter, and the span says how many."""
    tr = Tracer()
    cands = T.grid(n_nodes=[7], partitions=[(3, 3)], chunk_sizes=[256 * 1024])
    ops = T.CompileCache(enabled=False).compile_grid(
        lambda c: W.blast(3, n_queries=12, db_mb=128), cands, tracer=tr)
    (dag,) = [meta(s) for s in tr.spans() if s.name == "compile_dag"]
    assert dag["ops"] == ops[0].n_ops
    assert dag["bulk_ops"] / dag["ops"] > 0.95


# -- the what-if path ------------------------------------------------------------

def what_if_case(faults=None):
    wf = W.blast(3, n_queries=10, db_mb=16)
    cfg = T.partitioned_config(3, 3, chunk_size=T.MB,
                               faults=T.parse_faults(faults) if faults
                               else None)
    profiles = [T.PAPER_RAMDISK, T.PAPER_HDD,
                T.PAPER_RAMDISK.replace(storage=1.0 / (500 * T.MB))]
    return wf, cfg, profiles


@pytest.mark.parametrize("faults", [None, "disk=0:8"])
def test_what_if_records_four_parts_inside_its_root(faults):
    wf, cfg, profiles = what_if_case(faults)
    tr = Tracer()
    sess = T.SweepSession(T.InlineBackend(), device="cpu", tracer=tr)
    pred = T.Predictor(ST, session=sess)
    ops = pred.compile(wf, cfg)
    got = pred.what_if(wf, cfg, profiles)
    (root,) = [s for s in tr.spans() if s.name == "what_if"]
    assert meta(root) == {"ops": ops.n_ops, "profiles": len(profiles)}
    parts = sorted((s for s in tr.spans() if s.name.startswith("what_if.")),
                   key=lambda s: s.start)
    assert [s.name for s in parts] == list(WHAT_IF_PARTS)
    assert all(inside(s, root) for s in parts)
    assert all(a.end <= b.start + EPS for a, b in zip(parts, parts[1:]))
    vecs = np.stack([torch_sim.st_to_vec(p) for p in profiles])
    np.testing.assert_array_equal(got, torch_sim.sweep_service_times(
        ops, vecs, st_ref=ST, device="cpu"))


def test_what_if_with_tracing_off_is_the_untraced_path():
    wf, cfg, profiles = what_if_case()
    runs = []
    for tracer in (NULL_TRACER, Tracer()):
        sess = T.SweepSession(T.InlineBackend(), device="cpu", tracer=tracer)
        pred = T.Predictor(ST, session=sess)
        n0 = compile_count()
        out = pred.what_if(wf, cfg, profiles)
        runs.append((out, compile_count() - n0,
                     dataclasses.asdict(sess.stats)))
    (a, na, sa), (b, nb, sb) = runs
    np.testing.assert_array_equal(a, b)
    assert na == nb == 1 and sa == sb
    assert sa["kernel_launches"] == 0          # the CPU runs the plain loop
    assert NULL_TRACER.spans() == ()


# -- where a cold row's order is built ---------------------------------------------

@pytest.mark.parametrize("on_card", [False, True])
def test_prep_spans_and_counters_say_where_rows_were_ordered(on_card,
                                                             monkeypatch):
    """Each ``prep[...]`` span says how many of its rows the device
    ordered (``on_card``), ``what_if.scan_order`` whether it did; the
    engine's ``orders_on_card`` and ``orders_on_host`` count the
    scan-mode rows prepped (the row misses outside exact mode) and
    reset with the rest. A CPU stands in for the card."""
    if on_card:
        monkeypatch.setattr(torch_sim, "_orders_on_card", lambda dev: True)
    tr = Tracer()
    sess = T.SweepSession(T.InlineBackend(), device="cpu", tracer=tr)
    eng = sess.engine
    wf, cfg, profiles = what_if_case()
    ops = [T.compile_workflow(wf, c) for c in (
        cfg, dataclasses.replace(cfg, chunk_size=512 * 1024),
        what_if_case("disk=0:8,kill=1@1")[1])]
    for _ in range(2):                             # the second: row hits
        eng.simulate_batch(ops, [ST, T.PAPER_HDD, ST])
    preps = [meta(s) for s in tr.spans() if s.name.startswith("prep[")]
    # two buckets a sweep: the faulted DAG rides with the 1 MB one
    assert len(preps) == 4 and {m["faulted"] for m in preps} == {0, 1}
    st = sess.stats
    assert sum(m["on_card"] for m in preps) == st.orders_on_card
    assert st.orders_on_card + st.orders_on_host == st.row_misses == 3
    assert st.orders_on_card == (3 if on_card else 0)
    assert all(m["on_card"] <= m["rows"] for m in preps)
    eng.simulate_batch(ops[:1], [ST], exact=True)  # exact orders nothing
    assert st.row_misses == 4 and st.orders_on_card + st.orders_on_host == 3

    tr.clear()
    T.Predictor(ST, session=sess).what_if(wf, cfg, profiles)
    (part,) = [s for s in tr.spans() if s.name == "what_if.scan_order"]
    assert meta(part) == {"on_card": int(on_card)}
    assert st.orders_on_card + st.orders_on_host == 3
    st.reset()
    assert (st.orders_on_card, st.orders_on_host, st.row_misses) == (0, 0, 0)


@pytest.mark.gpu
def test_what_if_counts_its_kernel_launches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    wf, cfg, profiles = what_if_case()
    sess = T.SweepSession(device="cuda")
    pred = T.Predictor(ST, session=sess)
    first = pred.what_if(wf, cfg, profiles)     # builds the kernel
    k0 = sess.stats.kernel_launches
    again = pred.what_if(wf, cfg, profiles)
    assert sess.stats.kernel_launches - k0 == 1
    np.testing.assert_array_equal(first, again)
    cpu = T.Predictor(ST, session=T.SweepSession(device="cpu"))
    np.testing.assert_array_equal(again, cpu.what_if(wf, cfg, profiles))
