"""Backend equivalence in the port (repro_torch.core.sweep.backends), a
port of tests/test_backends.py.

`InlineBackend`, `ShardedBackend` and `MultiprocBackend` produce
**element-wise identical** makespans for the same sweep — on all three
`examples/traces` fixtures (read by the port's own readers), healthy and
under the fault axis, in scan and in exact mode — and equal to the
reference's `InlineBackend` on the same fixtures (read by its readers),
so backend choice is purely a throughput decision.

The sharded session names the one CPU device twice (see
`repro_torch.core.sweep.shard`), so every bucket is split in two. Exact
mode is a loop of one step per op on the CPU, so its legs run on an
index subset of each grid, as the verification rounds dispatch them.

The multi-process session is module-scoped: its worker fleet is
*session-owned* (a `PoolHandle`, not the process-wide shared pools), so
this file also exercises the owned-pool path end-to-end with real
workers, including the `close()` at module teardown.
"""
import asyncio
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.trace import load_trace, to_workflow

import repro_torch.core as T
from repro_torch.core import workloads as TW
from repro_torch.core.sweep import multiproc
from repro_torch.serve import AdvisorRequest, AdvisorServer

torch.set_num_threads(1)

TRACES = Path(__file__).resolve().parents[1] / "examples" / "traces"
FIXTURES = ["montage_small.json", "blast_small.json", "cycles_small.dax"]
ITEM_TIMEOUT_S = 120.0
TWO_SLOTS = [torch.device("cpu")] * 2


def fault_axis(P):
    """A healthy baseline, a degraded disk, a mid-run kill and a seeded
    mixed scenario, crossed into the grid."""
    return (None,
            P.FaultScenario(degraded=(P.DiskDegradation(0, 8.0),),
                            name="disk"),
            P.FaultScenario(failures=(P.NodeFailure(0, after_tasks=3),),
                            name="kill"),
            P.seeded_scenario(11, n_storage=2, n_clients=4, degrade=1,
                              straggle=1))


@pytest.fixture(scope="module")
def mp_session():
    with T.SweepSession(T.MultiprocBackend(2, item_timeout_s=ITEM_TIMEOUT_S),
                        device="cpu") as sess:
        yield sess
    assert sess.live_pools() == 0


def sweep_pairs(P, fixture, faults=False):
    if P is T:
        wf = T.trace.to_workflow(T.trace.load_trace(TRACES / fixture))
    else:
        wf = to_workflow(load_trace(TRACES / fixture))
    cands = P.grid(n_nodes=[7], chunk_sizes=[1 * P.MB])
    if faults:
        cands = P.with_faults(cands, fault_axis(P))
    return [wf] * len(cands), [c.to_config() for c in cands]


def check_backends(fixture, mp_session, faults):
    """Scan over every pair, exact over the last and first pair (healthy
    grid) or the last pair (faulted grid, whose first pair is the
    healthy grid's): the three port backends and the reference's inline
    backend, element for element."""
    wfs, cfgs = sweep_pairs(T, fixture, faults)
    jwfs, jcfgs = sweep_pairs(J, fixture, faults)
    # out of order on purpose: results come back in the order asked for
    exact_idxs = [len(cfgs) - 1] if faults else [len(cfgs) - 1, 0]
    with T.SweepSession(T.InlineBackend(), device="cpu") as inline, \
            T.SweepSession(T.ShardedBackend(TWO_SLOTS, min_shard_oprows=0),
                           device="cpu") as sharded, \
            J.SweepSession(J.InlineBackend()) as ref:
        runs = {"inline": inline.prepare(wfs, cfgs, st=T.PAPER_RAMDISK),
                "sharded": sharded.prepare(wfs, cfgs, st=T.PAPER_RAMDISK),
                "multiproc": mp_session.prepare(wfs, cfgs,
                                                st=T.PAPER_RAMDISK),
                "reference": ref.prepare(jwfs, jcfgs, st=J.PAPER_RAMDISK)}
        for idxs, exact in ((None, False), (exact_idxs, True)):
            want = np.asarray(runs["inline"].simulate(idxs, exact=exact))
            assert np.isfinite(want).all()
            for name in ("sharded", "multiproc", "reference"):
                got = np.asarray(runs[name].simulate(idxs, exact=exact))
                np.testing.assert_array_equal(
                    want, got, err_msg=f"{name} != inline ({fixture}, "
                                       f"exact={exact}, faults={faults})")
        assert sharded.stats.sharded_batch_calls == 2
        assert sharded.stats.device_rows
    assert mp_session.stats.mp_fallbacks == 0
    return len(cfgs)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_backends_element_wise_identical(fixture, mp_session):
    check_backends(fixture, mp_session, faults=False)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_backends_identical_under_fault_axis(fixture, mp_session):
    """Fault scenarios ride the grid as one more axis; the backends must
    stay element-wise identical with mixed healthy and faulted
    candidates in the same buckets (the multi-process leg also proves
    `FaultScenario` survives the spec pickle + class-key round trip)."""
    n = check_backends(fixture, mp_session, faults=True)
    assert n > len(sweep_pairs(T, fixture)[1])      # the axis took


def test_multiproc_session_owns_its_pool(mp_session):
    """The module fleet above really is session-owned: the handle lives
    in the session, not the process-wide shared registry."""
    assert mp_session.live_pools() >= 1
    handle = mp_session.pool_handle(2)
    assert handle.live and not handle.closed
    assert all(p is not handle._pool for p in multiproc._POOLS.values())


def test_advisor_server_on_a_multiproc_session_answers_as_inline(mp_session):
    """`AdvisorServer.from_predictor` shares a predictor's session, pools
    included: on a multi-process session the same requests give the same
    answers as on an inline one."""
    cands = T.grid(n_nodes=[7], partitions=[(2, 4)],
                   chunk_sizes=[512 * 1024, 1 * T.MB])
    wfs = [TW.blast(2, n_queries=q, db_mb=16, per_query_s=1.0)
           for q in (8, 10)]

    async def answers(sess):
        pred = T.Predictor(T.PAPER_RAMDISK, session=sess)
        async with AdvisorServer.from_predictor(pred,
                                                batch_window_s=0.05) as srv:
            assert srv.session is sess
            return await asyncio.gather(*(srv.submit(AdvisorRequest(
                workflow=wf, candidates=cands, verify_top_k=2,
                client=f"c{i}")) for i, wf in enumerate(wfs * 2)))

    items0 = mp_session.stats.mp_items
    with T.SweepSession(T.InlineBackend(), device="cpu") as inline:
        want = asyncio.run(answers(inline))
    got = asyncio.run(answers(mp_session))
    assert mp_session.stats.mp_items > items0       # the fleet served them
    assert mp_session.stats.mp_fallbacks == 0
    for w, g in zip(want, got):
        assert [e.index for e in w.evaluations] == \
            [e.index for e in g.evaluations]
        assert [e.verified for e in w.evaluations] == \
            [e.verified for e in g.evaluations]
        np.testing.assert_array_equal(w.makespans, g.makespans)
