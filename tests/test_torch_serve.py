"""The port's advisor service (`repro_torch.serve`) and checkpoint planner
(`repro_torch.checkpoint.planner`), on ``device="cpu"``.

The six tests of `tests/test_serve.py` restated on the port: every
response is element-wise identical to a direct per-request `explore` on
fresh state, coalesced questions compile strictly fewer DAGs than there
are requests, a results-cache hit costs zero compiles and zero
simulator batches, a new service digest invalidates lazily, deadlines
measured from submit fail cleanly, `from_predictor` shares the warm
session, and the lifecycle and validation guards hold. On top, the
answers are held against the reference's own server for the same
requests (same ranking, scan makespans to the bit, exact-verified ones
within ``rtol=1e-12``, exact mode's bound), and the planner's output
against `repro.checkpoint.planner`'s.
"""
import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import workloads as JW
from repro.checkpoint.planner import plan_checkpoint as j_plan
from repro.core.trace import GenSpec as JGenSpec
from repro.core.trace import generate_workflow as j_generate
from repro.core.trace import to_workflow as j_to_workflow
from repro.serve import AdvisorRequest as JRequest
from repro.serve import AdvisorServer as JServer

import repro_torch.core as T
from repro_torch.checkpoint import plan_checkpoint
from repro_torch.core import workloads as W
from repro_torch.core.compile import compile_count
from repro_torch.core.trace import GenSpec, generate_workflow, to_workflow
from repro_torch.serve import (AdvisorRequest, AdvisorServer,
                               DeadlineExceeded, QueryKey, ServerClosed,
                               grid_fingerprint, service_digest)
from repro_torch.serve import server as server_mod

torch.set_num_threads(1)

ST = T.PAPER_RAMDISK


def serve_grid(P=T):
    # a fixed workflow's client ranks must fit every candidate: pin the
    # partitions so n_app >= 2 for the 2-client blast workflows below
    return P.grid(n_nodes=[7], partitions=[(2, 4)],
                  chunk_sizes=[512 * 1024, 1 * P.MB])


def wf_a(M=W):
    return M.blast(2, n_queries=8, db_mb=16, per_query_s=1.0)


def wf_b(M=W):
    return M.blast(2, n_queries=10, db_mb=16, per_query_s=1.0)


def direct(wf, st=ST, verify_top_k=3):
    """The bit-identity reference: a per-request explore on fresh state."""
    with T.SweepSession(T.InlineBackend(), device="cpu") as sess:
        evals = T.explore(lambda c: wf, serve_grid(), st,
                          verify_top_k=verify_top_k, session=sess)
    return np.asarray([e.makespan for e in evals])


def req(wf, **kw):
    kw.setdefault("verify_top_k", 3)
    return AdvisorRequest(workflow=wf, candidates=serve_grid(), **kw)


def reference_answers(wfs, verify_top_k=3):
    """The reference's server answering the same questions."""
    async def main():
        async with JServer(J.PAPER_RAMDISK, batch_window_s=0.05) as srv:
            return await asyncio.gather(*(srv.submit(JRequest(
                workflow=wf, candidates=serve_grid(J),
                verify_top_k=verify_top_k)) for wf in wfs))
    return asyncio.run(main())


def assert_same_answer(port, ref):
    """Same ranking; scan makespans to the bit; verified makespans within
    exact mode's rtol=1e-12, unverified ones equal."""
    pe, re_ = port.evaluations, ref.evaluations
    assert [e.index for e in pe] == [e.index for e in re_]
    assert [e.verified for e in pe] == [e.verified for e in re_]
    assert [e.scan_makespan for e in pe] == [e.scan_makespan for e in re_]
    np.testing.assert_allclose(port.makespans, ref.makespans, rtol=1e-12)
    for a, b in zip(pe, re_):
        if not a.verified:
            assert a.makespan == b.makespan


def test_coalescing_cache_and_invalidation():
    base_a, base_b = direct(wf_a()), direct(wf_b())
    ref_a, ref_b = reference_answers([wf_a(JW), wf_b(JW)])

    async def main():
        # 8 concurrent clients, 2 distinct structural questions
        reqs = [req(wf_a() if i % 2 == 0 else wf_b(), client=f"c{i}")
                for i in range(8)]
        async with AdvisorServer(ST, batch_window_s=0.25,
                                 device="cpu") as srv:
            assert srv.session.device.type == "cpu"
            n0 = compile_count()
            resps = await asyncio.gather(*(srv.submit(r) for r in reqs))
            compiles = compile_count() - n0
            for i, r in enumerate(resps):
                np.testing.assert_array_equal(
                    r.makespans, base_a if i % 2 == 0 else base_b)
                assert_same_answer(r, ref_a if i % 2 == 0 else ref_b)
            assert 0 < compiles < len(reqs)     # coalesced: strictly fewer
            assert srv.stats.sweeps == 2        # one explore per question
            assert srv.stats.coalesced == len(reqs) - 2
            assert not any(r.cached for r in resps)
            assert {r.group_size for r in resps} == {4}

            # repeat queries: results-cache hits — zero compiles, zero
            # simulator batches, answers unchanged
            n1, b1 = compile_count(), srv.session.stats.batch_calls
            again = await asyncio.gather(srv.submit(reqs[0]),
                                         srv.submit(reqs[1]))
            assert all(r.cached for r in again)
            np.testing.assert_array_equal(again[0].makespans, base_a)
            np.testing.assert_array_equal(again[1].makespans, base_b)
            assert compile_count() == n1
            assert srv.session.stats.batch_calls == b1
            assert srv.results.stats.hits == 2

            # a re-identified system: stale answers invalidate lazily on
            # next lookup (digest mismatch), never get served
            st2 = ST.replace(storage=ST.storage * 2.0)
            assert service_digest(st2) != service_digest(ST)
            srv.set_service_times(st2)
            r2 = await srv.submit(reqs[0])
            assert not r2.cached
            assert srv.results.stats.invalidations == 1
            np.testing.assert_array_equal(r2.makespans, direct(wf_a(), st2))

    asyncio.run(main())


def test_generated_workflow_answer_equals_reference_server():
    """The question `examples/advisor_server.py` asks of a generated
    workflow (fan_out, depth 2, width 5, seed 3) on its 9-node grid,
    answered by both servers."""
    spec = dict(family="fan_out", depth=2, width=5)
    wf = to_workflow(generate_workflow(GenSpec(**spec), seed=3))
    jwf = j_to_workflow(j_generate(JGenSpec(**spec), seed=3))
    assert wf.fingerprint() == jwf.fingerprint()
    grid_kw = dict(n_nodes=[9], partitions=[(2, 6), (4, 4)],
                   chunk_sizes=[256 * 1024, 1 << 20])

    async def port():
        async with AdvisorServer(ST, device="cpu") as srv:
            return await srv.submit(AdvisorRequest(
                workflow=wf, candidates=T.grid(**grid_kw), verify_top_k=2))

    async def ref():
        async with JServer(J.PAPER_RAMDISK) as srv:
            return await srv.submit(JRequest(
                workflow=jwf, candidates=J.grid(**grid_kw), verify_top_k=2))

    assert_same_answer(asyncio.run(port()), asyncio.run(ref()))


def test_blast_grid_as_one_request_per_partition():
    """BLAST splits its queries over the candidate's app nodes, so its
    grid is asked as one fixed-workflow request per app-node count (the
    request names one workflow, as the reference's does). Two tenants
    asking the whole grid coalesce group by group; each answer equals a
    direct `explore` of its group, and together they are the sweep of
    the whole grid with a per-candidate workflow."""
    cands = T.grid(n_nodes=[6], chunk_sizes=[512 * 1024, 1 * T.MB])
    by_app = {}
    for c in cands:
        by_app.setdefault(c.n_app, []).append(c)
    wfs = {n: W.blast(n, n_queries=8, db_mb=16) for n in by_app}
    reqs = [AdvisorRequest(workflow=wfs[n], candidates=group, verify_top_k=0,
                           client=f"tenant{t}")
            for t in range(2) for n, group in by_app.items()]

    async def main():
        async with AdvisorServer(ST, device="cpu",
                                 batch_window_s=0.05) as srv:
            out = await asyncio.gather(*(srv.submit(r) for r in reqs))
            assert srv.stats.sweeps == len(by_app)
            assert srv.stats.coalesced == len(by_app)
            return out

    got = asyncio.run(main())
    with T.SweepSession(device="cpu") as sess:
        for r, resp in zip(reqs, got):
            want = T.explore(lambda c: r.workflow, r.candidates, ST,
                             verify_top_k=0, session=sess)
            assert list(resp.makespans) == [e.makespan for e in want]
        whole = T.explore(lambda c: wfs[c.n_app], cands, ST, verify_top_k=0,
                          session=sess)
    parts = sorted(m for resp in got[:len(by_app)] for m in resp.makespans)
    assert parts == sorted(e.makespan for e in whole)


# ---------------- one engine call for a batch's distinct questions ---------------

FAULTS = T.parse_faults("disk=0:8,kill=1@1")


def blast_question(n_app, subset, **kw):
    """BLAST asked about one partition of a 7-node cluster: the
    candidates of `serve_grid`'s two chunk sizes x stripe widths 0 and 1
    that ``subset`` picks, crossed with ``faults=`` where given."""
    faults = kw.pop("faults", None)
    cands = T.grid(n_nodes=[7], partitions=[(n_app, 6 - n_app)],
                   chunk_sizes=[512 * 1024, 1 * T.MB], stripe_widths=(0, 1))
    cands = [cands[i] for i in subset]
    if faults is not None:
        cands = T.with_faults(cands, faults)
    return AdvisorRequest(
        workflow=W.blast(n_app, n_queries=8, db_mb=16, per_query_s=1.0),
        candidates=cands, **kw)


def lone(r):
    """``r`` answered by one `explore` of its own on fresh state."""
    with T.SweepSession(T.InlineBackend(), device="cpu") as sess:
        return T.explore(lambda c: r.workflow, r.candidates, ST,
                         verify_top_k=r.verify_top_k, objective=r.objective,
                         locality_aware=r.locality_aware, session=sess)


def serve_at_once(reqs, monkeypatch):
    """Submit ``reqs`` concurrently into one admission batch; returns
    what each got (a response or the exception), the server's counters,
    the session's, and the question counts of each `explore_batch`."""
    calls = []

    def spy(questions, *a, **kw):
        calls.append(len(questions))
        return T.explore_batch(questions, *a, **kw)
    monkeypatch.setattr(server_mod, "explore_batch", spy)

    async def main():
        async with AdvisorServer(ST, batch_window_s=0.25,
                                 device="cpu") as srv:
            out = await asyncio.gather(*(srv.submit(r) for r in reqs),
                                       return_exceptions=True)
            assert srv.stats.batches == 1
            return out, srv.stats, srv.session.stats
    out, stats, sess_stats = asyncio.run(main())
    return out, stats, sess_stats, calls


def test_distinct_questions_of_a_batch_share_one_engine_call(monkeypatch):
    """Different partitions and subsets, a faulted candidate list that
    shares its buckets with a healthy one, verified shortlists and both
    objectives: one engine call, and every answer equal, field by field
    (order, index in its own list, makespans, cost, verified), to a lone
    `explore` of its question."""
    reqs = [blast_question(2, (0, 1, 3), verify_top_k=0),
            blast_question(3, (0, 1, 2, 3), verify_top_k=2,
                           objective="cost"),
            blast_question(2, (1, 2), faults=[None, FAULTS], verify_top_k=1),
            blast_question(4, (2, 3, 0), verify_top_k=3, objective="cost")]
    assert len({r.query_key() for r in reqs}) == len(reqs)
    got, stats, sess_stats, calls = serve_at_once(reqs, monkeypatch)
    assert calls == [len(reqs)]
    assert (stats.sweeps, stats.engine_sweeps) == (len(reqs), 1)
    # one scan-mode call and one exact-mode call for every shortlist
    assert (sess_stats.batch_calls, sess_stats.exact_batch_calls) == (2, 1)
    assert any(e.candidate.faults is not None and e.failed
               for e in got[2].evaluations)
    for r, resp in zip(reqs, got):
        assert resp.evaluations == lone(r)
        assert sorted(e.index for e in resp.evaluations) == \
            list(range(len(r.candidates)))
        assert sum(e.verified for e in resp.evaluations) == \
            min(r.verify_top_k, len(r.candidates))
        assert (resp.cached, resp.group_size) == (False, 1)


def test_identical_questions_in_a_shared_call_still_coalesce(monkeypatch):
    a, b = blast_question(2, (0, 1)), blast_question(3, (2, 3))
    reqs = [a, b, dataclasses.replace(a, client="twin"), blast_question(2, (3,))]
    got, stats, _, calls = serve_at_once(reqs, monkeypatch)
    assert calls == [3]
    assert (stats.sweeps, stats.engine_sweeps, stats.coalesced) == (3, 1, 1)
    assert stats.responses == len(reqs) and stats.errors == 0
    assert [r.group_size for r in got] == [2, 1, 2, 1]
    assert got[0].evaluations is got[2].evaluations
    for r, resp in zip(reqs, got):
        assert resp.evaluations == lone(r)


def test_question_that_fails_to_compile_fails_alone(monkeypatch):
    """A 3-client workflow asked of a 2-app-node partition cannot
    compile: the shared call raises, each question is swept alone, and
    only the bad one's ticket gets the error."""
    good_a, good_b = blast_question(2, (0, 2)), blast_question(3, (1, 3))
    bad = dataclasses.replace(blast_question(2, (1,)),
                              workflow=W.blast(3, n_queries=8, db_mb=16))
    got, stats, _, calls = serve_at_once([good_a, bad, good_b], monkeypatch)
    assert isinstance(got[1], IndexError)
    assert got[0].evaluations == lone(good_a)
    assert got[2].evaluations == lone(good_b)
    # the shared call, then one a question
    assert calls == [3, 1, 1, 1]
    assert (stats.sweeps, stats.engine_sweeps, stats.errors) == (3, 4, 1)
    assert stats.responses == 2


def test_lone_question_takes_the_explore_path(monkeypatch):
    """One distinct question in a batch is one engine call of one
    question, which runs `explore`'s own sweep: its answer equals a lone
    `explore`. So is each of two questions that differ in
    ``locality_aware`` (which changes the compile)."""
    a = blast_question(2, (0, 1, 2), verify_top_k=1)
    for reqs in ([a, dataclasses.replace(a, client="twin")],
                 [a, dataclasses.replace(blast_question(3, (0, 1)),
                                         locality_aware=False)]):
        got, stats, sess_stats, calls = serve_at_once(reqs, monkeypatch)
        n = len({r.query_key() for r in reqs})
        assert calls == [1] * n
        assert (stats.sweeps, stats.engine_sweeps) == (n, n)
        assert sess_stats.batch_calls == 2 * n    # a scan and an exact call
        for r, resp in zip(reqs, got):
            assert resp.evaluations == lone(r)


def test_deadline_expired_fails_cleanly():
    async def main():
        async with AdvisorServer(ST, batch_window_s=0.02,
                                 device="cpu") as srv:
            with pytest.raises(DeadlineExceeded):
                await srv.submit(req(wf_a(), verify_top_k=1, timeout_s=0.0))
            assert srv.stats.deadline_expired == 1
            assert srv.stats.sweeps == 0        # never occupied a sweep
            # the dispatcher survives: the next request is served
            ok = await srv.submit(req(wf_a(), verify_top_k=1))
            assert ok.makespans.size == len(serve_grid())
            np.testing.assert_array_equal(
                ok.makespans, direct(wf_a(), verify_top_k=1))

    asyncio.run(main())


def test_from_predictor_shares_warm_session():
    pred = T.Predictor(ST, device="cpu")

    async def main():
        async with AdvisorServer.from_predictor(pred) as srv:
            assert srv.session is pred.sweep_session()
            assert srv.service_times == ST
            r = await srv.submit(req(wf_a(), verify_top_k=1))
            np.testing.assert_array_equal(
                r.makespans, direct(wf_a(), verify_top_k=1))

    asyncio.run(main())
    # closing the server must not close a session it does not own
    assert not pred.sweep_session().closed


def test_lifecycle_guards():
    async def main():
        srv = AdvisorServer(ST, device="cpu")
        with pytest.raises(ServerClosed):       # not started
            await srv.submit(req(wf_a()))
        await srv.start()
        await srv.close()
        with pytest.raises(ServerClosed):       # closed
            await srv.submit(req(wf_a()))
        await srv.close()                       # idempotent
        assert srv.session.closed               # owned session torn down

    asyncio.run(main())
    with T.SweepSession(device="cpu") as sess:
        with pytest.raises(ValueError):         # two places to put it
            AdvisorServer(ST, session=sess, device="cpu")
        with pytest.raises(ValueError):
            AdvisorServer(session=sess)         # no service times at all
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            AdvisorServer(ST)                   # the card by default


def test_request_validation():
    with pytest.raises(ValueError):
        AdvisorRequest(workflow=wf_a(), candidates=())
    with pytest.raises(ValueError):
        AdvisorRequest(workflow=wf_a(), candidates=serve_grid(),
                       objective="latency")


def test_query_key_is_structural():
    # structurally-equal questions coalesce; any knob change separates
    a1, a2 = req(wf_a()), req(wf_a(), client="other")
    assert a1.query_key() == a2.query_key()     # client tag never keys
    assert a1.query_key() != req(wf_b()).query_key()
    assert a1.query_key() != req(wf_a(), verify_top_k=1).query_key()
    assert a1.query_key() != \
        req(wf_a(), locality_aware=False).query_key()
    # the query keys are the reference's, to the character; the service
    # digest is salted with each package's compiler digest, so the two
    # packages never serve each other's cached answers
    key: QueryKey = a1.query_key()
    jreq = JRequest(workflow=wf_a(JW), candidates=serve_grid(J),
                    verify_top_k=3)
    assert key == jreq.query_key()
    from repro.serve import service_digest as j_digest
    assert service_digest(ST) != j_digest(J.PAPER_RAMDISK)
    assert service_digest(ST) == service_digest(ST.replace())
    assert grid_fingerprint(serve_grid(), verify_top_k=1, objective="cost",
                            locality_aware=False) != key[1]


# ---------------- checkpoint planner ----------------------------------------------

@pytest.mark.parametrize("min_replication", [1, 2])
def test_plan_checkpoint_equals_reference(min_replication):
    kw = dict(min_replication=min_replication, chunk_sizes=(1 << 20, 4 << 20),
              stripe_widths=(0, 1, 4))
    total = 96 * (1 << 20)
    plan = plan_checkpoint(total, 5, ST, device="cpu", **kw)
    ref = j_plan(total, 5, J.PAPER_RAMDISK, **kw)
    assert plan.config.fingerprint() == ref.config.fingerprint()
    assert plan.local_placement == ref.local_placement
    assert plan.table == ref.table
    assert plan.predicted_write_s == ref.predicted_write_s
    assert plan.predicted_restore_s == ref.predicted_restore_s
    assert plan.config.replication >= min_replication


def test_plan_checkpoint_on_a_given_session():
    with T.SweepSession(device="cpu") as sess:
        plan = plan_checkpoint(64 * (1 << 20), 4, ST, session=sess,
                               chunk_sizes=(1 << 20,), stripe_widths=(0, 1),
                               verify_best=False)
        assert sess.stats.batch_calls == 1
    assert plan.predicted_write_s == plan.table[0]["predicted_write_s"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            plan_checkpoint(64 * (1 << 20), 5, ST)
