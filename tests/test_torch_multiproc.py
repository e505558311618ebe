"""Multi-process sweep dispatch in the port (repro_torch.core.sweep.multiproc),
a port of tests/test_multiproc.py.

The headline property is differential: for any sweep, at any worker
count — including class counts that straddle the worker-count boundary —
the multi-process path is **element-wise identical** to the port's
in-process engine, in both scan and exact mode, and ranks and scores
like the reference's inline sweep (scan makespans to the bit, verified
ones within exact mode's rtol=1e-12). On top of that sit the warm-start
counters: a fleet reloading a pre-populated `CompileCache(path=...)`
performs zero `compile_workflow` executions (counter-asserted via each
worker's `compile_count()` delta), and a cold disk-backed fleet compiles
each structural class exactly once across all workers.

Workers run on the CPU: the parent engine's device travels in every
work item. Worker pools are shared across this file (spawning a worker
and importing torch costs seconds); tests that assert worker-side
compile counters call `shutdown_pools()` first to force memory-cold
workers, and the fleet is shut at the end of the file. Every sweep the
tests build themselves carries an ``item_timeout_s``.
"""
import os
import subprocess
import sys
import time
from concurrent.futures import Future
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import workloads as JW
from repro.core.sweep.multiproc import partition_weighted as j_partition

import repro_torch.core as T
from repro_torch.core import workloads as TW
from repro_torch.core.compile import compile_count, compile_workflow
from repro_torch.core.sweep import multiproc
from repro_torch.core.sweep.multiproc import (MultiprocSweep,
                                              SysIdServiceTimes,
                                              partition_weighted,
                                              shutdown_pools)

from test_torch_shard import random_pairs
from test_torch_sweep import assert_same_evaluations

torch.set_num_threads(1)

ST = T.PAPER_RAMDISK
# deadline of every real-process item: far above a healthy item's
# seconds, so a hung worker falls back instead of hanging the run
ITEM_TIMEOUT_S = 120.0


@pytest.fixture(scope="module", autouse=True)
def shared_fleet():
    """The file shares the process-wide fleet; shut it at the end."""
    try:
        yield
    finally:
        shutdown_pools()


def blast_wf(W):
    return lambda c: W.blast(c.n_app, n_queries=6, db_mb=8, per_query_s=1.0)


def small_grid(P):
    return P.grid(n_nodes=[7], chunk_sizes=[512 * 1024, 1 * P.MB])


def cpu_engine(**kw):
    return T.SweepEngine(device="cpu", **kw)


def mp_session(workers, engine=None, cache=None):
    """What the legacy ``workers=`` kwargs build (`from_legacy`: the
    shared fleet), with a deadline on every item."""
    return T.SweepSession(
        T.MultiprocBackend(workers, shared_pools=True,
                           item_timeout_s=ITEM_TIMEOUT_S),
        engine=engine if engine is not None else cpu_engine(),
        compile_cache=cache if cache is not None else T.CompileCache())


def makespans(evals):
    return [e.makespan for e in evals]


@pytest.fixture(scope="module")
def inline_small_grid():
    """The port's and the reference's inline answers on `small_grid`."""
    with J.SweepSession(J.InlineBackend()) as sj:
        ref = J.explore(blast_wf(JW), small_grid(J), J.PAPER_RAMDISK,
                        verify_top_k=3, session=sj)
    port = T.explore(blast_wf(TW), small_grid(T), ST, verify_top_k=3,
                     engine=cpu_engine(), compile_cache=T.CompileCache())
    assert_same_evaluations(ref, port)
    return ref, port


def assert_same_as_inline(inline, got):
    ref, port = inline
    assert [e.index for e in got] == [e.index for e in port]
    np.testing.assert_array_equal(makespans(got), makespans(port))
    assert [e.verified for e in got] == [e.verified for e in port]
    assert_same_evaluations(ref, got)


# ---------------- partitioner ----------------------------------------------------

def check_partition(weights, n_items):
    runs = partition_weighted(weights, n_items)
    flat = [i for run in runs for i in run]
    assert flat == list(range(len(weights)))        # order-stable, complete
    assert all(run for run in runs)                 # non-empty items
    if weights:
        assert 1 <= len(runs) <= min(n_items, len(weights))
    assert runs == partition_weighted(weights, n_items)   # deterministic
    assert runs == j_partition(weights, n_items)          # the reference's


def test_partition_weighted_straddles_worker_boundaries():
    # class counts that do not divide the item count, the empty sweep,
    # single-class sweeps, and heavily skewed weights
    for weights, n_items in [([1] * 5, 2), ([1] * 5, 3), ([1] * 7, 3),
                             ([1] * 2, 4), ([3], 2), ([], 2),
                             ([100, 1, 1, 1], 2), ([1, 1, 1, 100], 3)]:
        check_partition(weights, n_items)


def test_partition_weighted_equals_reference_on_seeded_weights():
    rng = np.random.default_rng(7)
    for _ in range(200):
        n = int(rng.integers(0, 40))
        weights = [int(w) for w in rng.integers(1, 50, size=n)]
        check_partition(weights, int(rng.integers(1, 9)))


# ---------------- differential: multiproc == in-process == reference --------------

def test_explore_multiproc_two_workers(inline_small_grid):
    eng = cpu_engine()
    with mp_session(2, engine=eng) as sess:
        mp = T.explore(blast_wf(TW), small_grid(T), ST, verify_top_k=3,
                       session=sess)
    assert_same_as_inline(inline_small_grid, mp)
    assert eng.stats.mp_items > 0 and eng.stats.mp_fallbacks == 0


def test_explore_many_multiproc_three_workers_straddling():
    # 5 workflows x 2 candidates -> a class count that straddles the
    # 3-worker boundary; scan and the per-group exact shortlists both
    # run through the fleet
    def wfs(W):
        return [W.blast(2, n_queries=q, db_mb=8, per_query_s=1.0)
                for q in (2, 3, 4, 5, 6)]

    def cands(P):
        return P.grid(n_nodes=[7], chunk_sizes=[1 * P.MB],
                      partitions=[(2, 4), (4, 2)])

    with J.SweepSession(J.InlineBackend()) as sj:
        ref = J.explore_many(wfs(JW), cands(J), J.PAPER_RAMDISK,
                             verify_top_k=1, session=sj)
    base = T.explore_many(wfs(TW), cands(T), ST, verify_top_k=1,
                          engine=cpu_engine(), compile_cache=T.CompileCache())
    eng = cpu_engine()
    with mp_session(3, engine=eng) as sess:
        mp = T.explore_many(wfs(TW), cands(T), ST, verify_top_k=1,
                            session=sess)
    assert eng.stats.mp_fallbacks == 0
    assert len(ref) == len(base) == len(mp) == 5
    for g_ref, g_base, g_mp in zip(ref, base, mp):
        assert [e.index for e in g_base] == [e.index for e in g_mp]
        np.testing.assert_array_equal(makespans(g_base), makespans(g_mp))
        assert [e.verified for e in g_base] == [e.verified for e in g_mp]
        assert_same_evaluations(g_ref, g_mp)


def test_successive_halving_multiproc_matches():
    with J.SweepSession(J.InlineBackend()) as sj:
        ref = J.successive_halving(blast_wf(JW), small_grid(J),
                                   J.PAPER_RAMDISK, session=sj)
    base = T.successive_halving(blast_wf(TW), small_grid(T), ST,
                                engine=cpu_engine(),
                                compile_cache=T.CompileCache())
    with mp_session(2) as sess:
        mp = T.successive_halving(blast_wf(TW), small_grid(T), ST,
                                  session=sess)
        assert sess.stats.mp_fallbacks == 0
    assert [e.index for e in base] == [e.index for e in mp]
    np.testing.assert_array_equal(makespans(base), makespans(mp))
    assert all(e.verified for e in mp)
    assert_same_evaluations(ref, mp)


@pytest.mark.parametrize("n,exact", [(1, False), (2, True), (3, False),
                                     (5, True)])
def test_simulate_matches_engine_on_random_workflows(n, exact):
    """`MultiprocSweep.simulate` vs `SweepEngine.simulate_batch` on a
    batch of random workflows (batch sizes straddle the 2-worker
    boundary)."""
    pairs = random_pairs(T, 300 + n, n)
    wfs, cfgs = [w for w, _ in pairs], [c for _, c in pairs]
    ops = [compile_workflow(w, c) for w, c in pairs]
    want = cpu_engine().simulate_batch(ops, [ST] * n, exact=exact)
    eng = cpu_engine()
    mp = MultiprocSweep(wfs, cfgs, st=ST, workers=2, engine=eng,
                        cache=T.CompileCache(), item_timeout_s=ITEM_TIMEOUT_S)
    np.testing.assert_array_equal(want, mp.simulate(exact=exact))
    assert eng.stats.mp_fallbacks == 0


# ---------------- warm-start + compile counters -----------------------------------

def test_prepopulated_disk_cache_workers_compile_nothing(tmp_path,
                                                         inline_small_grid):
    """Workers reloading a pre-populated `CompileCache(path=...)` perform
    ZERO `compile_workflow` executions — counter-asserted via each
    worker's own `compile_count()` delta, rolled up into
    `worker_compiles`."""
    T.CompileCache(path=tmp_path).compile_grid(blast_wf(TW), small_grid(T))
    shutdown_pools()                                  # memory-cold workers
    cache = T.CompileCache(path=tmp_path)
    eng = cpu_engine()
    n0 = compile_count()
    with mp_session(2, engine=eng, cache=cache) as sess:
        mp = T.explore(blast_wf(TW), small_grid(T), ST, verify_top_k=3,
                       session=sess)
    assert compile_count() == n0                      # parent compiled nothing
    assert sum(cache.stats.worker_compiles.values()) == 0   # ...nor any worker
    assert cache.stats.disk_hits >= 1                 # served from the shared dir
    assert eng.stats.mp_fallbacks == 0
    assert_same_as_inline(inline_small_grid, mp)


def test_cold_fleet_compiles_each_class_exactly_once(tmp_path):
    """Cold disk-backed fleet: classes are partitioned whole, so the
    per-worker compile counts sum to the deduped structural-class count
    (the verify round disk-hits instead of recompiling)."""
    shutdown_pools()
    cache = T.CompileCache(path=tmp_path)
    eng = cpu_engine()
    with mp_session(2, engine=eng, cache=cache) as sess:
        groups = T.explore_many(
            [TW.blast(2, n_queries=q, db_mb=8, per_query_s=1.0)
             for q in (2, 3, 4)],
            T.grid(n_nodes=[7], chunk_sizes=[512 * 1024, 1 * T.MB],
                   partitions=[(2, 4)]),
            ST, verify_top_k=1, session=sess)
    assert all(any(e.verified for e in g) for g in groups)
    assert eng.stats.mp_fallbacks == 0 and eng.stats.mp_late_drops == 0
    assert sum(cache.stats.worker_compiles.values()) == \
        cache.stats.grid_classes
    assert len(cache.stats.worker_compiles) <= 2


def test_worker_rows_and_kernel_counters_roll_up():
    eng = cpu_engine()
    cache = T.CompileCache()
    with mp_session(2, engine=eng, cache=cache) as sess:
        T.explore(blast_wf(TW), small_grid(T), ST, verify_top_k=2,
                  session=sess)
    s = eng.stats
    assert s.mp_fallbacks == 0 and s.mp_late_drops == 0
    assert 1 <= len(s.worker_rows) <= 2
    # every padded row this engine accounts for was simulated by a worker
    assert sum(s.worker_rows.values()) == s.padded_rows
    assert s.sims == len(small_grid(T)) + 2        # scan + exact shortlist
    assert s.exact_sims == 2
    # CPU workers run the plain loop: every worker scan batch counted one
    # kernel fallback (rolled up), and no worker launched the kernel
    assert s.batch_calls == s.mp_items
    assert s.kernel_fallbacks == s.batch_calls - s.exact_batch_calls > 0
    assert s.kernel_launches == 0
    # every field of the engine rollup reaches the parent, the kernel's
    # launch count among them (on a card, the workers' K1 launches)
    mp = MultiprocSweep([], [], st=ST, workers=2, engine=eng, cache=cache)
    before = {f: getattr(s, f) for f in multiproc._ENGINE_ROLLUP}
    mp._roll_up("w-probe", {f: 3 for f in multiproc._ENGINE_ROLLUP},
                {f: 1 for f in multiproc._CACHE_ROLLUP}, 2)
    assert "kernel_launches" in multiproc._ENGINE_ROLLUP
    assert all(getattr(s, f) == before[f] + 3
               for f in multiproc._ENGINE_ROLLUP)
    assert s.worker_rows["w-probe"] == 3
    assert cache.stats.worker_compiles["w-probe"] == 2


def test_workers_one_degrades_to_in_process():
    eng = cpu_engine()
    T.explore(blast_wf(TW), small_grid(T), ST, verify_top_k=2, engine=eng,
              compile_cache=T.CompileCache(), workers=1)
    assert eng.stats.mp_items == 0
    assert not eng.stats.worker_rows
    assert eng.stats.batch_calls >= 1               # ran on this engine


def test_engine_workers_is_the_default_fanout(inline_small_grid):
    eng = cpu_engine(workers=2)
    mp = T.explore(blast_wf(TW), small_grid(T), ST, verify_top_k=3,
                   engine=eng, compile_cache=T.CompileCache())  # no workers=
    assert eng.stats.mp_items > 0 and eng.stats.mp_fallbacks == 0
    assert_same_as_inline(inline_small_grid, mp)


def test_predictor_workers_matches_in_process():
    tc, jc = small_grid(T), small_grid(J)
    wfs, cfgs = [blast_wf(TW)(c) for c in tc], [c.to_config() for c in tc]
    base = T.Predictor(ST, compile_cache=T.CompileCache(),
                       device="cpu").predict_batch(wfs, cfgs)
    pred = T.Predictor(ST, compile_cache=T.CompileCache(), workers=2,
                       device="cpu")
    got = pred.predict_batch(wfs, cfgs)
    np.testing.assert_array_equal(base, got)
    sess = pred.sweep_session()
    assert isinstance(sess.backend, T.MultiprocBackend)
    assert sess.stats.mp_items > 0 and sess.stats.mp_fallbacks == 0
    ref = J.Predictor(J.PAPER_RAMDISK, session=J.SweepSession()).predict_batch(
        [blast_wf(JW)(c) for c in jc], [c.to_config() for c in jc])
    np.testing.assert_array_equal(ref, got)


# ---------------- sysid warm-start ------------------------------------------------

def test_sysid_report_reference_resolves_in_workers(tmp_path,
                                                    inline_small_grid):
    """Workers warm-start service times from the persisted SysIdReport
    (one load per worker) instead of unpickling them; the parent's
    in-process path resolves the same reference."""
    path = tmp_path / "sysid.json"
    T.SysIdReport(service_times=ST, n_measurements=1, details={}).save(path)
    ref = SysIdServiceTimes(str(path))
    with mp_session(2) as sess:
        via_ref_mp = T.explore(blast_wf(TW), small_grid(T), ref,
                               verify_top_k=3, session=sess)
        assert sess.stats.mp_fallbacks == 0
    via_ref_local = T.explore(blast_wf(TW), small_grid(T), ref,
                              verify_top_k=3, engine=cpu_engine(),
                              compile_cache=T.CompileCache())
    assert_same_as_inline(inline_small_grid, via_ref_mp)
    assert_same_as_inline(inline_small_grid, via_ref_local)


def test_sysid_reference_refreshes_on_a_rewritten_report(tmp_path):
    """A worker's memo is keyed by the report file's identity: a report
    rewritten in place (re-identification) is read again, never served
    stale."""
    path = tmp_path / "sysid.json"
    ref = SysIdServiceTimes(str(path))
    st2 = ST.replace(storage=ST.storage * 2.0, net_latency=ST.net_latency * 3)
    cands = small_grid(T)
    wfs, cfgs = [blast_wf(TW)(c) for c in cands], [c.to_config() for c in cands]
    ops = [compile_workflow(w, c) for w, c in zip(wfs, cfgs)]
    with mp_session(2) as sess:
        for k, st in enumerate((ST, st2)):
            T.SysIdReport(service_times=st, n_measurements=1,
                          details={}).save(path)
            # a distinct mtime, whatever the file system's clock grain
            os.utime(path, ns=(k * 10 ** 9, k * 10 ** 9))
            got = sess.prepare(wfs, cfgs, st=ref).simulate()
            want = cpu_engine().simulate_batch(ops, [st] * len(ops))
            np.testing.assert_array_equal(want, got)
        assert sess.stats.mp_fallbacks == 0


# ---------------- the worker side ----------------------------------------------------

def test_worker_process_imports_neither_jax_nor_the_reference():
    probe = ("sorted(m for m in __import__('sys').modules if m.split('.')[0] "
             "in ('jax', 'repro', 'repro_torch'))")
    mods = multiproc._get_pool(2).submit(eval, probe).result(
        timeout=ITEM_TIMEOUT_S)
    assert "repro_torch.core.sweep.multiproc" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")]
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, repro_torch.core.sweep.multiproc; "
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('jax', 'repro')))"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_parent_device_travels_in_the_item():
    """`_worker_run` runs on the engine for the device it is sent, one
    per device string, and never picks another: asked for ``cuda`` on a
    host without a card it raises (and the parent falls back)."""
    c = small_grid(T)[0]
    wf, cfg = blast_wf(TW)(c), c.to_config()
    want = cpu_engine().simulate_batch([compile_workflow(wf, cfg)] * 2,
                                       [ST] * 2)
    multiproc._worker_init()
    try:
        item = (0, [(wf, cfg, 2)], ST, True, None, False, "auto", False)
        rid, values, _, e_delta, _, n_comp, spans = \
            multiproc._worker_run(*item, "cpu")
        assert rid == 0 and isinstance(values, np.ndarray)
        np.testing.assert_array_equal(values, want)
        assert n_comp == 1 and e_delta["padded_rows"] == 2 and spans == []
        assert list(multiproc._W["engines"]) == ["cpu"]
        assert multiproc._W["engines"]["cpu"].device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                multiproc._worker_run(*item, "cuda")
    finally:
        multiproc._W.clear()


# ---------------- degraded fleet --------------------------------------------------

def test_item_timeout_falls_back_in_process():
    """An expired item deadline degrades that item to the parent engine
    (values unchanged) without tearing down the healthy pool."""
    cands = small_grid(T)
    wfs = [blast_wf(TW)(c) for c in cands]
    cfgs = [c.to_config() for c in cands]
    eng = cpu_engine()
    mp = MultiprocSweep(wfs, cfgs, st=ST, workers=2, engine=eng,
                        cache=T.CompileCache(), item_timeout_s=1e-9)
    got = mp.simulate()
    assert eng.stats.mp_fallbacks > 0
    ops = [compile_workflow(w, c) for w, c in zip(wfs, cfgs)]
    want = cpu_engine().simulate_batch(ops, [ST] * len(ops))
    np.testing.assert_array_equal(want, got)
    assert multiproc._POOLS                         # pool survived


def test_broken_pool_falls_back_in_process(monkeypatch, inline_small_grid):
    """A dead pool must degrade the sweep, not fail it: every item runs
    in-process through the parent engine, results unchanged."""
    class BrokenPool:
        def submit(self, *a, **kw):
            raise RuntimeError("cannot schedule new futures after shutdown")

    monkeypatch.setattr(multiproc, "_get_pool", lambda workers: BrokenPool())
    eng = cpu_engine()
    mp = T.explore(blast_wf(TW), small_grid(T), ST, verify_top_k=3,
                   engine=eng, compile_cache=T.CompileCache(), workers=2)
    assert eng.stats.mp_fallbacks > 0
    assert not eng.stats.worker_rows                # nothing ran remotely
    assert_same_as_inline(inline_small_grid, mp)


# ---------------- slow/hung-worker regression tier --------------------------------
#
# Fake pools, no real processes: each future's state is scripted, so the
# merge loop's deadline arithmetic, respawn accounting, and late-drop
# counting are exercised deterministically (and without waiting on
# spawn + torch import). The fallback path is the real one — parent
# cache, parent engine — so the values asserts are real too.

class FakePool:
    def __init__(self, make_future):
        self._make = make_future

    def submit(self, fn, *a, **kw):
        return self._make()


class FakeHandle:
    """Quacks like `PoolHandle` (``executor()``/``respawn()``) but vends
    scripted futures and counts respawns."""

    def __init__(self, make_future):
        self._pool = FakePool(make_future)
        self.respawns = 0

    def executor(self):
        return self._pool

    def respawn(self):
        self.respawns += 1


def degraded_mp(eng, cache, make_future, **kw):
    """A MultiprocSweep over `small_grid` whose pool vends scripted
    futures, plus the in-process reference answer."""
    cands = small_grid(T)
    wfs = [blast_wf(TW)(c) for c in cands]
    cfgs = [c.to_config() for c in cands]
    handle = FakeHandle(make_future)
    mp = MultiprocSweep(wfs, cfgs, st=ST, workers=2, engine=eng,
                        cache=cache, pool=handle, **kw)
    ops = [compile_workflow(w, c) for w, c in zip(wfs, cfgs)]
    want = cpu_engine().simulate_batch(ops, [ST] * len(ops))
    return mp, handle, want


def test_hung_worker_merge_completes_in_o_timeout():
    """With ``item_timeout_s`` set, a merge over N items of hung workers
    completes in O(timeout), not O(N x timeout) — every item's deadline
    clock starts at submit, so the expirations overlap instead of
    serializing through the merge loop."""
    eng, cache = cpu_engine(), T.CompileCache()
    # warm pass: same item shapes, ~zero budget — pays the DAG compiles
    # and bucket preps so the timed pass measures only deadlines
    mp0, _, want = degraded_mp(eng, cache, Future, item_timeout_s=1e-9)
    np.testing.assert_array_equal(want, mp0.simulate())
    timeout = 1.0
    mp, handle, want = degraded_mp(eng, cache, Future,
                                   item_timeout_s=timeout)
    before = eng.stats.mp_items
    t0 = time.perf_counter()
    got = mp.simulate()
    dt = time.perf_counter() - t0
    n_items = eng.stats.mp_items - before
    assert n_items >= 3                    # O(timeout) vs O(N x timeout)
    np.testing.assert_array_equal(want, got)
    assert dt < 2.5 * timeout              # serialized: >= n_items * timeout
    assert handle.respawns == 0            # timeouts never churn the pool
    assert eng.stats.mp_late_drops == 0    # pending futures cancel cleanly


def test_broken_generation_respawns_pool_exactly_once():
    """Every item of a broken dispatch generation raises BrokenExecutor
    at harvest; the pool is respawned ONCE — not once per item — and the
    whole sweep completes in-process with identical values."""
    def broken_future():
        f = Future()
        f.set_exception(BrokenProcessPool("worker died"))
        return f

    eng, cache = cpu_engine(), T.CompileCache()
    mp, handle, want = degraded_mp(eng, cache, broken_future)
    got = mp.simulate()
    np.testing.assert_array_equal(want, got)
    assert handle.respawns == 1
    assert eng.stats.mp_fallbacks == eng.stats.mp_items >= 2
    assert eng.stats.mp_late_drops == 0


def test_late_result_after_failed_cancel_is_counted():
    """A timed-out item whose worker already started (``cancel()``
    fails) re-runs in-process; the worker's eventual result — values and
    counter rollup — is dropped, and the drop is counted so worker
    counter asserts know to stand down."""
    def running_future():
        f = Future()
        assert f.set_running_or_notify_cancel()   # cancel() now fails
        return f

    eng, cache = cpu_engine(), T.CompileCache()
    mp, handle, want = degraded_mp(eng, cache, running_future,
                                   item_timeout_s=1e-3)
    got = mp.simulate()
    np.testing.assert_array_equal(want, got)
    assert eng.stats.mp_late_drops == eng.stats.mp_items > 0
    assert eng.stats.mp_fallbacks == eng.stats.mp_items
    assert handle.respawns == 0
