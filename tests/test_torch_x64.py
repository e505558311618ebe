"""The f32 sweep mode (``REPRO_SIM_X64=0``) of the port against the
reference's, on the CPU.

Under ``REPRO_SIM_X64=0`` the reference rounds its f64 NumPy arrays to
f32 where they become device arrays and computes in f32 from there; its
engine runs the Pallas sweep-scan kernel in interpret mode. The port
rounds the same arrays at the same point (`core.x64.sim_dtype`) and runs
its kernel's plain version. The bar is `np.array_equal`, tolerance none:
scan and exact-verified makespans, rankings and per-op `end`, on the
three trace fixtures, a generated family and a faulted bucket. Also the
reference's own f32 test (scan within the golden fixture tolerance of
exact) restated on the port, a flip of the switch between two sweeps on
one session, the multi-process backend under the switch, and K1's f32
contract on the CPU model of its tile schedule.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import jax_sim as j_sim
from repro.core.trace import (GenSpec as JGenSpec, generate_family as
                              j_generate_family, load_trace, to_workflow)
from repro.core.x64 import enable_x64
from repro.kernels.sweep_scan import sweep_scan as j_sweep_scan

import repro_torch.core as T
from repro_torch.core import torch_sim, x64
from repro_torch.core.sweep import shutdown_pools
from repro_torch.kernels.sweep_scan import kernel as t_kernel
from repro_torch.kernels.sweep_scan import ops as t_ops

from test_torch_sweep import cand_key
from test_torch_sweep_scan import tile_schedule_scan
from test_trace import FIXTURE_SCAN_EXACT_RTOL
from torch_scan_buckets import adversarial_bucket, random_bucket

torch.set_num_threads(1)

TRACES = Path(__file__).resolve().parents[1] / "examples" / "traces"
FIXTURES = ["montage_small.json", "blast_small.json", "cycles_small.dax"]
FAULT_SPEC = "disk=0:8,kill=1@3"


@pytest.fixture
def f32(monkeypatch):
    """Both packages in their f32 mode for the test, restored after."""
    monkeypatch.setenv("REPRO_SIM_X64", "0")
    assert x64.sim_dtype() == torch.float32


def cpu_session(**kw):
    return T.SweepSession(T.InlineBackend(), device="cpu", **kw)


def fixture_pair(name):
    return (to_workflow(load_trace(TRACES / name)),
            T.trace.to_workflow(T.trace.load_trace(TRACES / name)))


def assert_same(ej, et):
    """Same ranking, and every makespan (scan and verified) equal."""
    assert [cand_key(e.candidate) for e in ej] == \
        [cand_key(e.candidate) for e in et]
    assert [e.index for e in ej] == [e.index for e in et]
    assert [e.verified for e in ej] == [e.verified for e in et]
    np.testing.assert_array_equal([e.scan_makespan for e in et],
                                  [e.scan_makespan for e in ej])
    np.testing.assert_array_equal([e.makespan for e in et],
                                  [e.makespan for e in ej])


def assert_f32_buckets(sess):
    keys = sess.engine.cache_keys()
    assert keys and all(k[7] == torch.float32 for k in keys)


# ---------------- the switch itself ------------------------------------------------

def test_switch_is_read_per_call(monkeypatch):
    monkeypatch.delenv("REPRO_SIM_X64", raising=False)
    assert x64.x64_wanted() and x64.sim_dtype() == torch.float64
    monkeypatch.setenv("REPRO_SIM_X64", "0")
    assert not x64.x64_wanted() and x64.sim_dtype() == torch.float32
    monkeypatch.setenv("REPRO_SIM_X64", "1")
    assert x64.sim_dtype() == torch.float64


def test_arrays_are_rounded_where_they_become_tensors(f32):
    """The op, fault and service-time arrays round from f64 NumPy to f32
    at construction, as the reference's ``jnp.asarray`` does."""
    jwf, twf = fixture_pair("montage_small.json")

    def cfg(P):
        return P.grid(n_nodes=[9], chunk_sizes=[P.MB],
                      faults=(P.parse_faults(FAULT_SPEC),))[0].to_config()

    ops = T.compile_workflow(twf, cfg(T))
    assert torch_sim.faulted(ops)
    a, fa = torch_sim.estimated_order(ops, None, "cpu").arrays()
    ja = j_sim.OpArrays.from_micro_ops(J.compile_workflow(jwf, cfg(J)))
    for name in ("nbytes", "reqs", "extra", "nlat"):
        t = getattr(a, name)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), getattr(ops, name)
                                      .astype(np.float32))
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(ja, name)))
    assert fa.res_mult.dtype == fa.dead.dtype == torch.float32
    neutral = torch_sim.FaultArrays.neutral(8, 3, device="cpu")
    assert neutral.res_mult.dtype == torch.float32
    st = torch_sim.st_tensor(torch_sim.st_to_vec(T.PAPER_RAMDISK)[None],
                             torch.device("cpu"))
    assert st.dtype == torch.float32
    np.testing.assert_array_equal(
        st.numpy()[0], j_sim.st_to_vec(J.PAPER_RAMDISK).astype(np.float32))


# ---------------- the port's f32 sweep against the reference's ----------------------

@pytest.mark.parametrize("fixture", FIXTURES)
def test_f32_sweep_equals_reference_on_fixtures(f32, fixture):
    """`explore` with exact verification over a 9-node grid, and the best
    candidate's per-op `end` from a single scan run."""
    jwf, twf = fixture_pair(fixture)
    with J.SweepSession(J.InlineBackend()) as sj, cpu_session() as st:
        ej = J.explore(lambda c: jwf, J.grid(n_nodes=[9], chunk_sizes=[J.MB]),
                       J.PAPER_RAMDISK, verify_top_k=2, session=sj)
        et = T.explore(lambda c: twf, T.grid(n_nodes=[9], chunk_sizes=[T.MB]),
                       T.PAPER_RAMDISK, verify_top_k=2, session=st)
        assert sj.stats.kernel_buckets > 0       # the Pallas kernel ran
        assert_same(ej, et)
        assert_f32_buckets(st)
        best = et[0].candidate.to_config()
        jr = j_sim.simulate(J.compile_workflow(jwf, ej[0].candidate
                                               .to_config()),
                            J.PAPER_RAMDISK, timeline=True)
        tr = torch_sim.simulate(T.compile_workflow(twf, best),
                                T.PAPER_RAMDISK, timeline=True, device="cpu")
        assert tr.timeline.end.dtype == np.float32
        np.testing.assert_array_equal(tr.timeline.end, jr.timeline.end)
        assert tr.makespan == jr.makespan


def test_f32_sweep_equals_reference_on_a_family(f32):
    """`explore_many` over a generated family, one batched run."""
    spec = dict(family="fan_out", depth=2, width=4, mean_mb=4.0,
                runtime_s=0.5)
    jwfs = [to_workflow(t) for t in j_generate_family(JGenSpec(**spec), 3,
                                                      seed=5)]
    twfs = [T.trace.to_workflow(t)
            for t in T.trace.generate_family(T.trace.GenSpec(**spec), 3,
                                             seed=5)]
    with J.SweepSession(J.InlineBackend()) as sj, cpu_session() as st:
        gj = J.explore_many(jwfs, J.grid(n_nodes=[7], chunk_sizes=[J.MB]),
                            J.PAPER_RAMDISK, verify_top_k=1, session=sj)
        gt = T.explore_many(twfs, T.grid(n_nodes=[7], chunk_sizes=[T.MB]),
                            T.PAPER_RAMDISK, verify_top_k=1, session=st)
        for ej, et in zip(gj, gt):
            assert_same(ej, et)
        assert_f32_buckets(st)


def test_f32_sweep_equals_reference_on_a_faulted_bucket(f32):
    """Healthy and faulted rows in one bucket (the healthy ones on
    neutral fault arrays), with replication."""
    jwf, twf = fixture_pair("montage_small.json")

    def cands(P):
        return P.grid(n_nodes=[7], chunk_sizes=[P.MB], replications=(1, 2),
                      faults=(None, P.parse_faults(FAULT_SPEC)))

    with J.SweepSession(J.InlineBackend()) as sj, cpu_session() as st:
        ej = J.explore(lambda c: jwf, cands(J), J.PAPER_RAMDISK,
                       verify_top_k=0, session=sj)
        et = T.explore(lambda c: twf, cands(T), T.PAPER_RAMDISK,
                       verify_top_k=0, session=st)
        assert_same(ej, et)
        assert any(k[5] for k in st.engine.cache_keys())
        assert_f32_buckets(st)


@pytest.mark.parametrize("bucket", ["random", "adversarial"])
def test_f32_scan_buckets_equal_reference_kernel(bucket):
    """One bucket in f32, the port's plain version against the
    reference's Pallas kernel (interpret mode): makespan and end."""
    arrays = (random_bucket(640, 3, 8, 21) if bucket == "random"
              else adversarial_bucket(320, 3, 5, 22, 16))
    res, dur, lag, deps = arrays
    dur, lag = dur.astype(np.float32), lag.astype(np.float32)
    mk_t, end_t = t_ops.sweep_scan(*(torch.from_numpy(a) for a in
                                     (res, dur, lag, deps)),
                                   n_resources=8, use_kernel=True)
    assert mk_t.dtype == end_t.dtype == torch.float32
    with enable_x64():
        mk_k, end_k = j_sweep_scan(res, dur, lag, deps, n_resources=8,
                                   use_kernel=True, block_rows=64)
    assert np.asarray(mk_k).dtype == np.float32
    np.testing.assert_array_equal(mk_t.numpy(), np.asarray(mk_k))
    np.testing.assert_array_equal(end_t.numpy(), np.asarray(end_k))


# ---------------- the reference's own f32 bar, and the switch mid-session ----------

def test_sweep_f32_within_golden_rtol(f32):
    """`tests/test_sweep_kernel.py::test_sweep_f32_within_golden_rtol` on
    the port: scan tracks exact within the golden fixture tolerance."""
    twf = T.trace.to_workflow(T.trace.load_trace(TRACES / "montage_small.json"))
    cfg = T.grid(n_nodes=[9], chunk_sizes=[T.MB],
                 partitions=[(4, 4)])[0].to_config()
    pred = T.Predictor(T.PAPER_RAMDISK, session=cpu_session(), device="cpu")
    exact = pred.predict(twf, cfg, backend="exact").makespan
    scan = pred.predict(twf, cfg, backend="scan").makespan
    assert scan == pytest.approx(exact, rel=FIXTURE_SCAN_EXACT_RTOL), (
        f"f32 scan drifted {abs(scan - exact) / exact:.2%} from exact "
        f"(golden bound {FIXTURE_SCAN_EXACT_RTOL:.1%})")


def test_switch_flipped_between_sweeps_on_one_session(monkeypatch):
    """f64, then f32, then f64 again on one warm session: each sweep's
    values and bucket dtype equal a fresh session's in that mode."""
    _, twf = fixture_pair("cycles_small.dax")
    cands = T.grid(n_nodes=[9], chunk_sizes=[T.MB])

    def sweep(sess):
        ev = T.explore(lambda c: twf, cands, T.PAPER_RAMDISK, verify_top_k=1,
                       session=sess)
        return [(e.index, e.makespan, e.scan_makespan) for e in ev]

    monkeypatch.setenv("REPRO_SIM_X64", "1")
    with cpu_session() as warm:
        first = sweep(warm)
        monkeypatch.setenv("REPRO_SIM_X64", "0")
        second = sweep(warm)
        assert {k[7] for k in warm.engine.cache_keys()} == \
            {torch.float64, torch.float32}
        with cpu_session() as fresh:
            assert second == sweep(fresh)
            assert_f32_buckets(fresh)
        monkeypatch.setenv("REPRO_SIM_X64", "1")
        assert sweep(warm) == first
    assert second != first            # f32 rounds: the values do differ


def test_multiproc_workers_follow_the_parents_switch(monkeypatch):
    """Workers spawned in f64 serve an f32 sweep in f32: the dtype rides
    the work item, not the worker's environment."""
    _, twf = fixture_pair("cycles_small.dax")
    cands = T.grid(n_nodes=[9], chunk_sizes=[T.MB])
    monkeypatch.setenv("REPRO_SIM_X64", "1")
    try:
        with T.SweepSession(T.MultiprocBackend(2), device="cpu") as mp, \
                cpu_session() as inline:
            T.explore(lambda c: twf, cands, T.PAPER_RAMDISK, verify_top_k=0,
                      session=mp)                 # the fleet spawns in f64
            monkeypatch.setenv("REPRO_SIM_X64", "0")
            got = T.explore(lambda c: twf, cands, T.PAPER_RAMDISK,
                            verify_top_k=0, session=mp)
            want = T.explore(lambda c: twf, cands, T.PAPER_RAMDISK,
                             verify_top_k=0, session=inline)
            assert mp.stats.mp_items > 0 and mp.stats.mp_fallbacks == 0
            assert [(e.index, e.makespan) for e in got] == \
                [(e.index, e.makespan) for e in want]
    finally:
        shutdown_pools()


# ---------------- K1's f32 contract on the CPU model of its schedule ---------------

@pytest.mark.parametrize("value", [-0.5, -1e-30, -0.0, float("nan"),
                                   float("inf"), -float("inf")])
def test_f32_tile_schedule_equals_reference_kernel_on_any_value(value):
    """The kernel's schedule computed in f32 (both walks, both memory
    regimes) and the plain version, equal to the reference's f32 Pallas
    kernel, with ``value`` at seeded places of dur and lag and every lag
    of one candidate negative (C1's inputs)."""
    n_ops, tile = 100, 8
    res, dur, lag, deps = adversarial_bucket(n_ops, 4, 5, 3, tile)
    rng = np.random.default_rng(4)
    for arr in (dur, lag):
        arr[rng.integers(0, 3, 6), rng.integers(0, n_ops, 6)] = value
    lag[1] -= 0.05
    dur, lag = dur.astype(np.float32), lag.astype(np.float32)
    arrays = (res, dur, lag, deps)
    with enable_x64():
        mk_k, end_k = (np.asarray(v) for v in j_sweep_scan(
            *arrays, n_resources=5, use_kernel=True, block_rows=20))
    assert mk_k.dtype == np.float32
    mk_t, end_t = (t.numpy() for t in t_ops.sweep_scan(
        *(torch.from_numpy(a) for a in arrays), n_resources=5,
        use_kernel=True))
    np.testing.assert_array_equal(mk_t, mk_k)
    np.testing.assert_array_equal(end_t, end_k)
    for ring in (False, True):
        mk, end, _ = tile_schedule_scan(*arrays, 5, tile, ring)
        assert mk.dtype == end.dtype == np.float32
        np.testing.assert_array_equal(mk, mk_k)
        np.testing.assert_array_equal(end, end_k)


def test_f32_wrapper_contract():
    """dur and lag of one float type, f64 or f32; outputs take it."""
    res, dur, lag, deps = (torch.from_numpy(a)
                           for a in random_bucket(16, 2, 3, 0))
    for dt in (torch.float64, torch.float32):
        mk, end = t_ops.sweep_scan(res, dur.to(dt), lag.to(dt), deps,
                                   n_resources=3, use_kernel=True)
        assert mk.dtype == end.dtype == dt
    with pytest.raises(TypeError):
        t_ops.sweep_scan(res, dur.float(), lag, deps, n_resources=3,
                         use_kernel=True)
    with pytest.raises(TypeError):
        t_ops.sweep_scan(res, dur.half(), lag.half(), deps, n_resources=3,
                         use_kernel=True)
    assert set(t_kernel.FLOAT_TYPES) == {torch.float64, torch.float32}
