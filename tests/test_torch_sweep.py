"""The slice as a whole: the port's sweep stack (`SweepSession` +
`InlineBackend` + `explore` / `explore_many` / `successive_halving` /
`Predictor`, ``device="cpu"``) against the reference's, over the grids
of the reference's own sweep and fault tests.

Scan makespans: `np.array_equal`, tolerance none. Exact-verified
makespans: ``rtol=1e-12`` (the bound both packages are held to against
`ref_sim`). Rankings: the same candidates in the same order.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import workloads as JW
from repro.core.trace import load_trace, to_workflow

import repro_torch.core as T
from repro_torch.core import compile as t_compile
from repro_torch.core import ref_sim as t_ref
from repro_torch.core import workloads as TW
from repro_torch.core.sweep import CompileCache, bucket_of
from repro_torch.obs import Tracer

# the CPU paths step through tiny tensors one op at a time, where
# PyTorch's intra-op thread pool costs more than it gives and fights
# the other test workers for cores
torch.set_num_threads(1)

TRACES = Path(__file__).resolve().parents[1] / "examples" / "traces"
FIXTURES = ["montage_small.json", "blast_small.json", "cycles_small.dax"]
FAULT_SPEC = "disk=0:8,kill=1@40"


def blast_wf(W):
    return lambda c: W.blast(c.n_app, n_queries=12, db_mb=32, per_query_s=1.0)


def small_grid(P):
    return P.grid(n_nodes=[7], chunk_sizes=[512 * 1024, 1 * P.MB])


def cpu_session(**kw):
    return T.SweepSession(T.InlineBackend(), device="cpu", **kw)


def cand_key(c):
    return (c.n_nodes, c.n_app, c.n_storage, c.chunk_size, c.stripe_width,
            c.replication, str(c.placement.value),
            c.faults.fingerprint() if c.faults is not None else None)


def assert_same_evaluations(ej, et):
    """Same ranking; scan makespans equal to the bit; verified ones
    within rtol=1e-12."""
    assert [cand_key(e.candidate) for e in ej] == \
        [cand_key(e.candidate) for e in et]
    assert [e.index for e in ej] == [e.index for e in et]
    assert [e.verified for e in ej] == [e.verified for e in et]
    np.testing.assert_array_equal([e.scan_makespan for e in ej],
                                  [e.scan_makespan for e in et])
    np.testing.assert_allclose([e.makespan for e in et],
                               [e.makespan for e in ej], rtol=1e-12)
    for a, b in zip(ej, et):
        if not a.verified:
            assert a.makespan == b.makespan


def fixture_pair(name):
    jwf = to_workflow(load_trace(TRACES / name))
    return jwf, T.trace.to_workflow(T.trace.load_trace(TRACES / name))


# ---------------- explore / explore_many / successive_halving ----------------------

@pytest.mark.parametrize("verify_top_k", [0, 3])
def test_explore_parity_blast_small_grid(verify_top_k):
    with J.SweepSession(J.InlineBackend()) as sj, cpu_session() as st:
        ej = J.explore(blast_wf(JW), small_grid(J), J.PAPER_RAMDISK,
                       verify_top_k=verify_top_k, session=sj)
        et = T.explore(blast_wf(TW), small_grid(T), T.PAPER_RAMDISK,
                       verify_top_k=verify_top_k, session=st)
        assert_same_evaluations(ej, et)
        # one exact batch for the whole shortlist, as in the reference
        assert st.stats.exact_batch_calls == sj.stats.exact_batch_calls
        assert st.stats.exact_sims == sj.stats.exact_sims
        assert st.stats.sims == sj.stats.sims
        assert st.stats.padded_rows == sj.stats.padded_rows
        assert [k[:6] for k in st.engine.cache_keys()] == \
            [k[:6] for k in sj.engine.cache_keys()]


@pytest.mark.parametrize("fixture", FIXTURES)
def test_explore_parity_fixtures_with_fault_axis(fixture):
    jwf, twf = fixture_pair(fixture)
    jg = J.grid(n_nodes=[7], chunk_sizes=[J.MB])
    tg = T.grid(n_nodes=[7], chunk_sizes=[T.MB])
    with J.SweepSession(J.InlineBackend()) as sj, cpu_session() as st:
        ej = J.explore(lambda c: jwf, jg, J.PAPER_RAMDISK,
                       verify_top_k=1, session=sj,
                       faults=(None, J.parse_faults(FAULT_SPEC)))
        et = T.explore(lambda c: twf, tg, T.PAPER_RAMDISK,
                       verify_top_k=1, session=st,
                       faults=(None, T.parse_faults(FAULT_SPEC)))
    # the scenario is skipped for partitions too small to host it
    assert len(tg) < len(et) == len(ej) <= 2 * len(tg)
    assert_same_evaluations(ej, et)


def test_explore_many_parity():
    jm, tm = fixture_pair("montage_small.json")
    jg = J.grid(n_nodes=[7], chunk_sizes=[J.MB])
    tg = T.grid(n_nodes=[7], chunk_sizes=[T.MB])
    with J.SweepSession(J.InlineBackend()) as sj, cpu_session() as st:
        gj = J.explore_many([jm, blast_wf(JW)], jg, J.PAPER_RAMDISK,
                            verify_top_k=1, session=sj)
        gt = T.explore_many([tm, blast_wf(TW)], tg, T.PAPER_RAMDISK,
                            verify_top_k=1, session=st)
        assert st.stats.exact_batch_calls == 1 == sj.stats.exact_batch_calls
        assert st.compile_stats.grid_calls == 1
    assert len(gj) == len(gt) == 2
    for ej, et in zip(gj, gt):
        assert_same_evaluations(ej, et)


def test_successive_halving_parity():
    with J.SweepSession(J.InlineBackend()) as sj, cpu_session() as st:
        ej = J.successive_halving(blast_wf(JW), small_grid(J),
                                  J.PAPER_RAMDISK, eta=3, session=sj)
        et = T.successive_halving(blast_wf(TW), small_grid(T),
                                  T.PAPER_RAMDISK, eta=3, session=st)
        assert_same_evaluations(ej, et)
        assert all(e.verified for e in et)
        assert st.stats.exact_batch_calls == sj.stats.exact_batch_calls


def test_scatter_gather_sweep_matches_ref_sim():
    def wf_for(c):
        return TW.scatter_gather(c.n_app, in_mb=64, shard_mb=16, out_mb=4)

    cands = T.grid(n_nodes=[8], chunk_sizes=[512 * 1024])
    with cpu_session() as sess:
        evals = T.explore(wf_for, cands, T.PAPER_RAMDISK,
                          verify_top_k=len(cands), session=sess)
    assert all(e.verified for e in evals)
    for e in evals:
        ops = T.compile_workflow(wf_for(e.candidate), e.candidate.to_config())
        np.testing.assert_allclose(
            e.makespan, t_ref.simulate(ops, T.PAPER_RAMDISK).makespan,
            rtol=1e-12)
    front = T.pareto_front(evals)
    assert front and all(a.makespan <= b.makespan
                         for a, b in zip(front, front[1:]))


# ---------------- the faulted golden pin -------------------------------------------

def test_golden_pin_replication_wins_degraded_montage_sweep():
    """montage_small + spinning disks + storage node 0 serving 16x slow:
    the replication sweep picks r=2, the healthy one r=1 — in the port
    as in the reference, with equal scan makespans."""
    jwf, twf = fixture_pair("montage_small.json")
    kw = dict(n_nodes=[9], partitions=[(4, 4)], replications=[1, 2])
    jsc = J.FaultScenario(degraded=(J.DiskDegradation(0, 16.0),),
                          name="golden-disk0x16")
    tsc = T.FaultScenario(degraded=(T.DiskDegradation(0, 16.0),),
                          name="golden-disk0x16")
    jc = J.grid(chunk_sizes=[J.MB], faults=[jsc], **kw)
    tc = T.grid(chunk_sizes=[T.MB], faults=[tsc], **kw)
    with J.SweepSession(J.InlineBackend()) as sj, cpu_session() as st:
        ej = J.explore(lambda c: jwf, jc, J.PAPER_HDD,
                       verify_top_k=len(jc), session=sj)
        et = T.explore(lambda c: twf, tc, T.PAPER_HDD,
                       verify_top_k=len(tc), session=st)
        assert_same_evaluations(ej, et)
        assert all(e.verified and not e.failed for e in et)
        assert et[0].candidate.replication == 2
        by_r = {e.candidate.replication: e.makespan for e in et}
        assert by_r[2] < by_r[1]
        healthy = T.explore(lambda c: twf, T.grid(chunk_sizes=[T.MB], **kw),
                            T.PAPER_HDD, verify_top_k=2, session=st)
        assert healthy[0].candidate.replication == 1


# ---------------- caches and counters ----------------------------------------------

def test_warm_resweep_no_misses_no_compiles():
    cands = small_grid(T)
    with cpu_session() as sess:
        first = T.explore(blast_wf(TW), cands, T.PAPER_RAMDISK,
                          verify_top_k=0, session=sess)
        s = sess.stats
        assert s.misses > 0 and s.row_misses == len(cands)
        before = (s.misses, s.row_misses, s.stack_misses,
                  t_compile.compile_count(), sess.compile_stats.misses)
        again = T.explore(blast_wf(TW), cands, T.PAPER_RAMDISK,
                          verify_top_k=0, session=sess)
        assert (s.misses, s.row_misses, s.stack_misses,
                t_compile.compile_count(),
                sess.compile_stats.misses) == before
        assert s.hits > 0 and s.stack_hits > 0
        assert [e.makespan for e in again] == [e.makespan for e in first]


def test_cache_is_lru_bounded():
    eng = T.SweepEngine(max_entries=2, device="cpu")
    cands = T.grid(n_nodes=[6, 8, 10, 12], chunk_sizes=[512 * 1024])
    with T.SweepSession(engine=eng) as sess:
        T.explore(blast_wf(TW), cands, T.PAPER_RAMDISK, verify_top_k=0,
                  session=sess)
    assert eng.stats.evictions > 0 and eng.cache_keys() == []


def test_bucket_grouping_matches_reference():
    from repro.core.sweep import bucket_of as j_bucket_of
    for cj, ct in zip(small_grid(J), small_grid(T)):
        oj = J.compile_workflow(blast_wf(JW)(cj), cj.to_config())
        ot = T.compile_workflow(blast_wf(TW)(ct), ct.to_config())
        assert j_bucket_of(oj) == bucket_of(ot)


def test_neutral_rows_equal_healthy_bucket():
    """A healthy row simulated inside a faulted bucket (neutral x1.0 /
    +0.0 arrays) equals the all-healthy bucket's value to the bit."""
    wf = TW.blast(4, n_queries=12, db_mb=32)
    healthy = [T.partitioned_config(4, 3, chunk_size=ck)
               for ck in (512 * 1024, T.MB)]
    sick = [c.replace(faults=T.parse_faults("disk=0:8")) for c in healthy]
    with cpu_session() as sess:
        alone = sess.simulate_batch([wf] * 2, healthy, st=T.PAPER_RAMDISK)
        mixed = sess.simulate_batch([wf] * 4, healthy + sick,
                                    st=T.PAPER_RAMDISK)
        assert any(k[5] for k in sess.engine.cache_keys())
    np.testing.assert_array_equal(mixed[:2], alone)
    assert (mixed[2:] != alone).all()


def test_disk_cache_warm_start_and_own_digest(tmp_path):
    cands = small_grid(T)[:4]
    with cpu_session(cache_dir=str(tmp_path)) as s1:
        v1 = T.explore(blast_wf(TW), cands, T.PAPER_RAMDISK, verify_top_k=0,
                       session=s1)
        assert s1.compile_stats.disk_stores == s1.compile_stats.misses > 0
    n0 = t_compile.compile_count()
    with cpu_session(compile_cache=CompileCache(path=tmp_path)) as s2:
        v2 = T.explore(blast_wf(TW), cands, T.PAPER_RAMDISK, verify_top_k=0,
                       session=s2)
        assert s2.compile_stats.misses == 0 and s2.compile_stats.disk_hits > 0
    assert t_compile.compile_count() == n0
    assert [e.makespan for e in v1] == [e.makespan for e in v2]
    # the reference package reads none of the port's entries
    jc = J.CompileCache(path=tmp_path)
    c = small_grid(J)[0]
    jc.get(blast_wf(JW)(c), c.to_config())
    assert jc.stats.disk_hits == 0 and jc.stats.misses == 1


def test_tracer_records_phases_without_changing_results():
    cands = small_grid(T)[:4]
    tr = Tracer()
    with cpu_session(tracer=tr) as traced, cpu_session() as plain:
        a = T.explore(blast_wf(TW), cands, T.PAPER_RAMDISK, verify_top_k=1,
                      session=traced)
        b = T.explore(blast_wf(TW), cands, T.PAPER_RAMDISK, verify_top_k=1,
                      session=plain)
        assert dataclasses.asdict(traced.stats) == dataclasses.asdict(plain.stats)
    assert [e.makespan for e in a] == [e.makespan for e in b]
    phases = {s.phase for s in tr.spans()}
    assert {"compile", "host-prep", "device-sim", "exact-verify"} <= phases


# ---------------- session, predictor, what is left out ------------------------------

def test_session_lifecycle_and_sysid_default():
    class Report:
        service_times = T.PAPER_RAMDISK

    wf, cfg = TW.pipeline(3), T.partitioned_config(3, 2)
    sess = cpu_session(sysid=Report())
    assert sess.device.type == "cpu" and sess.engine.n_shards == 1
    v = sess.simulate_batch([wf], [cfg])
    assert v.shape == (1,) and v[0] > 0
    with pytest.raises(ValueError):
        cpu_session().prepare([wf], [cfg])
    with pytest.raises(TypeError):
        cpu_session(sysid=object())
    with pytest.raises(ValueError):
        cpu_session(compile_cache=CompileCache(), cache_dir="x")
    sess.close()
    assert sess.closed and sess.engine.cache_keys() == []
    with pytest.raises(RuntimeError):
        sess.prepare([wf], [cfg], st=T.PAPER_RAMDISK)


def test_parts_left_for_later_slices_raise():
    """The legacy ``workers=`` / ``devices=`` kwargs, which raised until
    the multi-process and sharded backends were ported, now pick them as
    the reference does; combining them with ``session=`` still raises."""
    wf = TW.pipeline(3)
    cands = T.grid(n_nodes=[5])
    with cpu_session() as sess:
        with pytest.raises(ValueError):
            T.explore(lambda c: wf, cands, T.PAPER_RAMDISK, session=sess,
                      workers=2)
    eng = T.SweepEngine(device="cpu")
    mp = T.SweepSession.from_legacy(engine=eng, compile_cache=CompileCache(),
                                    workers=2)
    assert isinstance(mp.backend, T.MultiprocBackend)
    assert mp.backend.workers == 2 and mp.engine is eng
    sharded = T.SweepSession.from_legacy(engine=eng,
                                         compile_cache=CompileCache(),
                                         devices=0)
    assert isinstance(sharded.backend, T.ShardedBackend)
    legacy = T.SweepSession.from_legacy(engine=eng,
                                        compile_cache=CompileCache())
    assert isinstance(legacy.backend, T.InlineBackend)
    assert legacy.engine is eng
    pred = T.Predictor(T.PAPER_RAMDISK, workers=2, device="cpu")
    assert isinstance(pred.sweep_session().backend, T.MultiprocBackend)
    pred = T.Predictor(T.PAPER_RAMDISK, devices=0, device="cpu")
    assert isinstance(pred.sweep_session().backend, T.ShardedBackend)


def test_predictor_backends_and_batch_parity():
    jwf, twf = JW.blast(4, n_queries=12, db_mb=32), TW.blast(4, n_queries=12,
                                                             db_mb=32)
    jcfg = J.partitioned_config(4, 3, chunk_size=J.MB)
    tcfg = T.partitioned_config(4, 3, chunk_size=T.MB)
    pj = J.Predictor(J.PAPER_RAMDISK, session=J.SweepSession())
    pt = T.Predictor(T.PAPER_RAMDISK, device="cpu")
    assert pt.sweep_session().device.type == "cpu"
    ref = pt.predict(twf, tcfg, backend="ref")
    exact = pt.predict(twf, tcfg, backend="exact")
    scan = pt.predict(twf, tcfg, backend="scan")
    assert ref.makespan == pj.predict(jwf, jcfg, backend="ref").makespan
    np.testing.assert_allclose(exact.makespan, ref.makespan, rtol=1e-12)
    assert scan.makespan == pj.predict(jwf, jcfg, backend="scan").makespan
    with pytest.raises(ValueError):
        pt.predict(twf, tcfg, backend="xla")
    cj, ct = small_grid(J)[:3], small_grid(T)[:3]
    np.testing.assert_array_equal(
        pj.predict_batch([blast_wf(JW)(c) for c in cj],
                         [c.to_config() for c in cj]),
        pt.predict_batch([blast_wf(TW)(c) for c in ct],
                         [c.to_config() for c in ct]))
    # a predictor on an explicit session follows that session's device
    with cpu_session() as sess:
        ps = T.Predictor(T.PAPER_RAMDISK, session=sess)
        assert ps.predict(twf, tcfg, backend="scan").makespan == scan.makespan
