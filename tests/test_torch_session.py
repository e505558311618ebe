"""`SweepSession` lifecycle and isolation in the port, a port of
tests/test_session.py.

Sessions are isolated units of sweep state — two sessions (or two
`Predictor`s) never clobber each other's mesh — with an explicit
lifecycle: `close()` shuts session-owned worker pools and releases the
engine's callable/host-prep LRUs, and repeated open/close cycles leak
nothing. The legacy kwargs on the search entry points remain equivalent
shims over a session and pick the backend the reference picks.
"""
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import workloads as JW

import repro_torch.core as T
from repro_torch.core import workloads as TW
from repro_torch.core.sweep import multiproc

torch.set_num_threads(1)

ST = T.PAPER_RAMDISK
TWO_SLOTS = [torch.device("cpu")] * 2


def blast_wf(W):
    return lambda c: W.blast(c.n_app, n_queries=6, db_mb=8, per_query_s=1.0)


def small_grid(P):
    return P.grid(n_nodes=[7], chunk_sizes=[512 * 1024, 1 * P.MB])


def sweep_pairs(P=T, W=TW):
    cands = small_grid(P)
    return [blast_wf(W)(c) for c in cands], [c.to_config() for c in cands]


def cpu_session(backend=None, **kw):
    return T.SweepSession(backend, device="cpu", **kw)


# ---------------- isolation: no sticky placement ----------------------------------

def test_two_predictors_keep_independent_meshes():
    """Predictor(devices=...) points its own private engine at the mesh;
    a second predictor's engine keeps one device, and interleaving
    re-places neither."""
    wfs, cfgs = sweep_pairs()
    sharded = T.Predictor(ST, devices=TWO_SLOTS, device="cpu")
    plain = T.Predictor(ST, workers=1, device="cpu")   # non-default => private
    a = sharded.predict_batch(wfs, cfgs)
    b = plain.predict_batch(wfs, cfgs)
    np.testing.assert_array_equal(a, b)
    assert isinstance(sharded.sweep_session().backend, T.ShardedBackend)
    assert isinstance(plain.sweep_session().backend, T.InlineBackend)
    assert sharded.sweep_session().engine.n_shards == 2
    assert plain.sweep_session().engine.n_shards == 1   # not clobbered
    assert sharded.sweep_session().engine is not plain.sweep_session().engine
    np.testing.assert_array_equal(sharded.predict_batch(wfs, cfgs), a)
    assert plain.sweep_session().mesh is None
    # ... and both equal the reference's predictor
    jw, jc = sweep_pairs(J, JW)
    np.testing.assert_array_equal(
        J.Predictor(J.PAPER_RAMDISK, session=J.SweepSession()).predict_batch(
            jw, jc), a)


def test_two_sessions_keep_independent_meshes():
    wfs, cfgs = sweep_pairs()
    with cpu_session(T.ShardedBackend(TWO_SLOTS, min_shard_oprows=0)) as s1, \
            cpu_session(T.InlineBackend()) as s2:
        a = s1.simulate_batch(wfs, cfgs, st=ST)
        b = s2.simulate_batch(wfs, cfgs, st=ST)
        np.testing.assert_array_equal(a, b)
        assert s1.engine.n_shards == 2 and s1.mesh == tuple(TWO_SLOTS)
        assert s1.stats.sharded_batch_calls == 1
        assert s2.mesh is None and s2.stats.sharded_batch_calls == 0


# ---------------- lifecycle: close() releases everything ---------------------------

class _FakePool:
    """Broken-pool scaffolding (as in test_torch_multiproc): submits fail,
    so items fall back in-process — pool *lifecycle* is exercised without
    paying a worker spawn per cycle."""

    def __init__(self):
        self.shut = False

    def submit(self, *a, **kw):
        raise RuntimeError("cannot schedule new futures after shutdown")

    def shutdown(self, wait=True, cancel_futures=False):
        self.shut = True


def test_open_close_cycles_do_not_leak_pools(monkeypatch):
    spawned = []

    def fake_spawn(workers):
        pool = _FakePool()
        spawned.append(pool)
        return pool

    monkeypatch.setattr(multiproc, "_spawn_pool", fake_spawn)
    wfs, cfgs = sweep_pairs()
    want = cpu_session().simulate_batch(wfs, cfgs, st=ST)
    for _ in range(3):
        with cpu_session(T.MultiprocBackend(2)) as sess:
            got = sess.simulate_batch(wfs, cfgs, st=ST)   # falls back in-process
            np.testing.assert_array_equal(want, got)
            assert sess.stats.mp_fallbacks > 0
            assert sess.live_pools() == 1
        assert sess.live_pools() == 0                     # close() shut it
    # one pool per cycle, every one shut down, none registered globally
    assert len(spawned) == 3 and all(p.shut for p in spawned)
    assert all(p not in multiproc._POOLS.values() for p in spawned)
    with pytest.raises(RuntimeError):
        sess.pool_handle(2)                               # closed: no new pools


def test_close_releases_engine_caches():
    wfs, cfgs = sweep_pairs()
    sess = cpu_session(T.ShardedBackend(TWO_SLOTS, min_shard_oprows=0))
    want = sess.simulate_batch(wfs, cfgs, st=ST)
    assert sess.engine.cache_keys()                       # callables pinned
    assert sess.engine.stats.row_misses > 0
    sess.close()
    assert not sess.engine.cache_keys()                   # LRUs released
    assert not sess.engine._rows and not sess.engine._stacks
    with pytest.raises(RuntimeError):
        sess.prepare(wfs, cfgs, st=ST)
    with pytest.raises(RuntimeError):
        sess.pool_handle(2)
    sess.close()                                          # idempotent
    np.testing.assert_array_equal(
        want, cpu_session().simulate_batch(wfs, cfgs, st=ST))


# ---------------- legacy kwargs == session path ------------------------------------

def test_legacy_kwargs_pick_the_reference_backend():
    """`from_legacy`: ``workers`` > 1 beats ``devices``, as in the
    reference; the multi-process pick borrows the shared fleet; an
    engine's own ``workers`` is the default fan-out."""
    eng = T.SweepEngine(device="cpu")
    cache = T.CompileCache()

    def pick(**kw):
        return T.SweepSession.from_legacy(engine=eng, compile_cache=cache,
                                          **kw)
    mp = pick(workers=2)
    assert isinstance(mp.backend, T.MultiprocBackend)
    assert mp.backend.workers == 2 and mp.backend.shared_pools
    assert isinstance(pick(workers=3, devices=0).backend, T.MultiprocBackend)
    assert isinstance(pick(devices=0).backend, T.ShardedBackend)
    assert isinstance(pick(workers=1).backend, T.InlineBackend)
    assert isinstance(pick().backend, T.InlineBackend)
    assert mp.engine is eng and mp.compile_cache is cache
    fan = T.SweepSession.from_legacy(engine=T.SweepEngine(device="cpu",
                                                          workers=4),
                                     compile_cache=cache)
    assert isinstance(fan.backend, T.MultiprocBackend)
    assert fan.backend.workers == 4


def test_legacy_kwargs_match_session_path():
    cands = small_grid(T)
    legacy = T.explore(blast_wf(TW), cands, ST, verify_top_k=3,
                       engine=T.SweepEngine(device="cpu"),
                       compile_cache=T.CompileCache(), devices=TWO_SLOTS)
    with cpu_session() as sess:
        new = T.explore(blast_wf(TW), cands, ST, verify_top_k=3,
                        session=sess)
    assert [e.index for e in legacy] == [e.index for e in new]
    np.testing.assert_array_equal([e.makespan for e in legacy],
                                  [e.makespan for e in new])
    assert [e.verified for e in legacy] == [e.verified for e in new]


def test_session_and_legacy_kwargs_are_exclusive():
    for kw in ({"workers": 2}, {"devices": 0},
               {"engine": T.SweepEngine(device="cpu")}):
        with pytest.raises(ValueError, match="not both"):
            T.explore(blast_wf(TW), small_grid(T), ST, session=cpu_session(),
                      **kw)


def test_predictor_sessions_are_private_unless_shared():
    """A predictor with any legacy knob derives a private session on its
    device (the DAG cache the caller gave, if any); an explicit
    ``session=`` is used as given, pools and all."""
    cache = T.CompileCache()
    p1 = T.Predictor(ST, workers=2, compile_cache=cache, device="cpu")
    p2 = T.Predictor(ST, workers=2, compile_cache=cache, device="cpu")
    s1, s2 = p1.sweep_session(), p2.sweep_session()
    assert s1 is not s2 and s1.engine is not s2.engine
    assert s1.compile_cache is cache is s2.compile_cache
    assert s1.device.type == "cpu" and s1 is p1.sweep_session()
    with cpu_session(T.MultiprocBackend(2)) as sess:
        assert T.Predictor(ST, session=sess).sweep_session() is sess
