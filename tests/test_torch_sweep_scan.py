"""The port's sweep-scan kernel package against the reference's.

On a CPU-only host the CUDA kernel cannot run, so what is compared here
is its plain PyTorch version (`repro_torch.kernels.sweep_scan.ref`, the
function the kernel is held against on the card by `chip_smoke.py`):
against the reference's `sweep_scan_ref` and against the reference's
Pallas kernel in interpret mode, on the same seeded NumPy inputs.
Tolerance: none — the recurrence is `max` and `+` in f64 in one order,
so `np.array_equal` on makespan and end. Plus the dispatch rules of
`ops.sweep_scan` and the engine's ``sim_engine`` knob.
"""
import numpy as np
import pytest
import torch

from repro.core.x64 import enable_x64
from repro.kernels.sweep_scan import sweep_scan as j_sweep_scan
from repro.kernels.sweep_scan.ref import sweep_scan_ref as j_sweep_scan_ref

import repro_torch.core as T
from repro_torch.core import workloads as TW
from repro_torch.core.sweep import engine as t_engine
from repro_torch.kernels import build as t_build
from repro_torch.kernels.sweep_scan import kernel as t_kernel
from repro_torch.kernels.sweep_scan import ops as t_ops
from repro_torch.kernels.sweep_scan import ref as t_ref

from torch_scan_buckets import MAXD, adversarial_bucket, random_bucket

# the CPU paths step through tiny tensors one op at a time, where
# PyTorch's intra-op thread pool costs more than it gives and fights
# the other test workers for cores
torch.set_num_threads(1)

# (n_ops, n_cand, n_res, seed): the boundary shapes of the reference's
# kernel tests, and its three multi-block rows (block_rows second)
BOUNDARY = [(1, 1, 1, 0), (7, 3, 4, 1), (8, 2, 8, 2), (9, 5, 3, 3),
            (19, 4, 6, 4)]
MULTI_BLOCK = [(64, 16), (64, 64), (128, 32)]


def torch_ref(arrays, n_res):
    res, dur, lag, deps = (torch.from_numpy(a) for a in arrays)
    mk, end = t_ops.sweep_scan(res, dur, lag, deps, n_resources=n_res,
                               use_kernel=True)     # CPU tensors: plain path
    assert mk.dtype == end.dtype == torch.float64
    return mk.numpy(), end.numpy()


def assert_all_equal(arrays, n_res, block_rows=256):
    mk_t, end_t = torch_ref(arrays, n_res)
    with enable_x64():
        mk_r, end_r = j_sweep_scan_ref(*arrays, n_resources=n_res)
        mk_k, end_k = j_sweep_scan(*arrays, n_resources=n_res,
                                   use_kernel=True, block_rows=block_rows)
    for mk, end in ((mk_r, end_r), (mk_k, end_k)):
        np.testing.assert_array_equal(mk_t, np.asarray(mk))
        np.testing.assert_array_equal(end_t, np.asarray(end))


@pytest.mark.parametrize("n_ops,n_cand,n_res,seed", BOUNDARY)
def test_plain_version_matches_reference_boundary_shapes(n_ops, n_cand,
                                                         n_res, seed):
    assert_all_equal(random_bucket(n_ops, n_cand, n_res, seed), n_res)


@pytest.mark.parametrize("n_ops,block_rows", MULTI_BLOCK)
def test_plain_version_matches_reference_multi_block(n_ops, block_rows):
    assert_all_equal(random_bucket(n_ops, 4, 8, seed=n_ops), 8,
                     block_rows=block_rows)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_matches_reference_dead_op_rows(seed):
    """Dead ops cost 1e30 s: sums stay finite and equal."""
    res, dur, lag, deps = random_bucket(48, 3, 5, seed)
    rng = np.random.default_rng(100 + seed)
    dur = dur.copy()
    dur[rng.random(dur.shape) < 0.1] += 1e30
    assert_all_equal((res, dur, lag, deps), 5)
    assert torch_ref((res, dur, lag, deps), 5)[0].max() >= 1e30


def test_forward_dep_reads_zero():
    """A dep on an op not yet served reads 0.0, in both packages."""
    res, dur, lag, deps = random_bucket(12, 2, 3, seed=7)
    deps[:, 2, 0] = 9
    assert_all_equal((res, dur, lag, deps), 3)


def test_scan_serve_is_one_row_of_the_batch():
    arrays = random_bucket(20, 3, 4, seed=5)
    mk_b, end_b = torch_ref(arrays, 4)
    res, dur, lag, deps = (torch.from_numpy(a) for a in arrays)
    mk1, end1 = t_ref.scan_serve(res[1], dur[1], lag[1], deps[1], 4)
    assert float(mk1) == mk_b[1]
    np.testing.assert_array_equal(end1.numpy(), end_b[1])


# ---------------- wrapper validation -----------------------------------------------

def _tensors(n_ops=8, n_cand=2, n_res=4):
    return [torch.from_numpy(a) for a in random_bucket(n_ops, n_cand, n_res, 0)]


@pytest.mark.parametrize("which,dtype", [(0, torch.int64), (1, torch.float32),
                                         (2, torch.float32), (3, torch.int64)])
def test_wrapper_rejects_wrong_dtype(which, dtype):
    args = _tensors()
    args[which] = args[which].to(dtype)
    with pytest.raises(TypeError):
        t_ops.sweep_scan(*args, n_resources=4, use_kernel=True)


def test_wrapper_rejects_non_contiguous():
    res, dur, lag, deps = _tensors(n_ops=8)
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.sweep_scan(res, dur.t().contiguous().t(), lag, deps,
                         n_resources=4, use_kernel=True)


@pytest.mark.parametrize("bad", ["dur", "lag", "deps_rows", "deps_slots",
                                 "rank"])
def test_wrapper_rejects_mismatched_shapes(bad):
    res, dur, lag, deps = _tensors(n_ops=8)
    if bad == "dur":
        dur = dur[:, :7].contiguous()
    elif bad == "lag":
        lag = lag[:1].contiguous()
    elif bad == "deps_rows":
        deps = deps[:, :7].contiguous()
    elif bad == "deps_slots":
        deps = deps[:, :, :2].contiguous()
    else:
        res = res[0].contiguous()
    with pytest.raises(ValueError):
        t_ops.sweep_scan(res, dur, lag, deps, n_resources=4, use_kernel=True)


def test_cuda_entry_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.sweep_scan_cuda(*_tensors(), n_resources=4)


def test_cpu_tensors_never_count_as_launches():
    stats = t_engine.CacheStats()
    t_ops.sweep_scan(*_tensors(), n_resources=4, use_kernel=True, stats=stats)
    t_ops.sweep_scan(*_tensors(), n_resources=4, use_kernel=False,
                     stats=stats)
    assert stats.kernel_launches == 0


class _FakeCudaTensor:
    """Stands in for a tensor on the card in the dispatch test: reports
    a CUDA device, everything else comes from the CPU tensor it wraps."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_cuda_tensor_with_library_missing_raises(monkeypatch):
    """For a CUDA tensor the wrapper launches the kernel or raises: a
    failed build must surface, never give way to the plain version."""
    def no_library(*a, **kw):
        raise t_build.KernelCompileError("nvcc not found")

    monkeypatch.setattr(t_kernel, "load", no_library)
    monkeypatch.setattr(t_ops, "sweep_scan_ref",
                        lambda *a, **kw: pytest.fail("fell back to plain"))
    args = [_FakeCudaTensor(t) for t in _tensors()]
    stats = t_engine.CacheStats()
    with pytest.raises(t_build.KernelCompileError):
        t_ops.sweep_scan(*args, n_resources=4, use_kernel=True, stats=stats)
    assert stats.kernel_launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(t_build, "nvcc_path", lambda: None)
    with pytest.raises(t_build.KernelCompileError, match="nvcc"):
        t_build.load_library("sweep_scan", [t_kernel.SOURCE],
                             t_kernel.EXTRA_FLAGS, build_dir=tmp_path)
    # the library name follows the source text and the flags
    a = t_build.library_path("k", [t_kernel.SOURCE], (), tmp_path)
    b = t_build.library_path("k", [t_kernel.SOURCE], ("-fmad=false",), tmp_path)
    assert a != b and a.parent == tmp_path


def test_load_library_builds_and_hashes_once_per_process(monkeypatch,
                                                          tmp_path):
    """A wrapper loads its library on every launch: after the first load
    the same handle comes back without reading or hashing the sources
    again; other flags name another library."""
    built = []

    def fake_build(name, sources, extra_flags=(), build_dir=None):
        built.append(tuple(extra_flags))
        return tmp_path / f"lib{name}_{len(built)}.so"

    monkeypatch.setattr(t_build, "build_library", fake_build)
    monkeypatch.setattr(t_build.ctypes, "CDLL", lambda path: object())
    t_build._load.cache_clear()
    try:
        a = t_build.load_library("k", [t_kernel.SOURCE], build_dir=tmp_path)
        assert t_build.load_library("k", [t_kernel.SOURCE],
                                    build_dir=tmp_path) is a
        assert built == [()]
        c = t_build.load_library("k", [t_kernel.SOURCE], ("-fmad=false",),
                                 build_dir=tmp_path)
        assert c is not a and built == [(), ("-fmad=false",)]
    finally:
        # the memo is the loader's only state: drop the fake handles
        t_build._load.cache_clear()


# ---------------- engine dispatch --------------------------------------------------

def _pairs():
    cands = T.grid(n_nodes=[6], chunk_sizes=[T.MB])
    wfs = [TW.blast(c.n_app, n_queries=6, db_mb=8) for c in cands]
    return wfs, [c.to_config() for c in cands]


def test_sim_engine_validation():
    assert set(t_engine.SIM_ENGINES) == {"auto", "cuda", "torch"}
    with pytest.raises(ValueError):
        T.SweepEngine(sim_engine="pallas", device="cpu")
    with pytest.raises(ValueError):
        T.SweepSession(sim_engine="mosaic", device="cpu")
    # the session knob re-points a borrowed engine
    eng = T.SweepEngine(sim_engine="torch", device="cpu")
    sess = T.SweepSession(engine=eng, sim_engine="auto")
    assert eng.sim_engine == "auto" and sess.engine is eng
    with pytest.raises(ValueError):
        T.SweepSession(engine=eng, sim_engine="xla")


def test_forced_cuda_raises_on_cpu_engine():
    wfs, cfgs = _pairs()
    with T.SweepSession(sim_engine="cuda", device="cpu") as sess:
        with pytest.raises(RuntimeError, match="cuda"):
            sess.simulate_batch(wfs, cfgs, st=T.PAPER_RAMDISK)


def test_auto_on_cpu_counts_one_fallback_per_scan_batch():
    wfs, cfgs = _pairs()
    with T.SweepSession(sim_engine="auto", device="cpu") as sa, \
            T.SweepSession(sim_engine="torch", device="cpu") as st:
        va = sa.simulate_batch(wfs, cfgs, st=T.PAPER_RAMDISK)
        vt = st.simulate_batch(wfs, cfgs, st=T.PAPER_RAMDISK)
        np.testing.assert_array_equal(va, vt)
        assert sa.stats.kernel_fallbacks == 1
        sa.simulate_batch(wfs, cfgs, st=T.PAPER_RAMDISK)
        assert sa.stats.kernel_fallbacks == 2
        # exact batches never want the kernel, so they count nothing
        sa.simulate_batch(wfs[:1], cfgs[:1], st=T.PAPER_RAMDISK, exact=True)
        assert sa.stats.kernel_fallbacks == 2
        assert sa.stats.kernel_buckets == 0
        assert st.stats.kernel_fallbacks == 0 and st.stats.kernel_buckets == 0
        assert not any(k[6] for k in sa.engine.cache_keys())


def test_cuda_engine_must_take_the_kernel(monkeypatch):
    """On a CUDA engine "auto" resolves to the kernel (and counts no
    fallback) — checked on the resolution rule itself, which needs no
    card."""
    eng = T.SweepEngine(sim_engine="auto", device="cpu")
    monkeypatch.setattr(t_ops, "cuda_supported", lambda device=None: True)
    assert eng._use_kernel(exact=False) is True
    assert eng._use_kernel(exact=True) is False
    assert eng.stats.kernel_fallbacks == 0
    eng.sim_engine = "torch"
    assert eng._use_kernel(exact=False) is False


# ---------------- service times of any sign --------------------------------------
#
# The kernel equals its plain version on every input: negative, infinite
# and NaN durations and lags included (it picks its own walk per
# candidate). So every scan bucket that wants the kernel takes it,
# whatever its service times: no domain check, no fallback. Checked on
# the CPU with the dispatch rule forced to the card's (`cuda_supported`
# -> True) and the wrapper replaced by a sentinel that records what each
# bucket asked for; the kernel itself in tests/test_torch_gpu.py.

def _sentinel(monkeypatch):
    asked = []
    real = t_ops.sweep_scan

    def sweep_scan(*args, use_kernel, **kw):
        asked.append(use_kernel)
        return real(*args, use_kernel=use_kernel, **kw)

    monkeypatch.setattr(t_ops, "cuda_supported", lambda device=None: True)
    monkeypatch.setattr(t_ops, "sweep_scan", sweep_scan)
    return asked


def _two_ops_one_resource():
    """Two ops on resource 1, the second depending on the first,
    dur = (1, 1) (all of it `extra`); nlat = (1, 0), so net_latency -0.5
    makes lag = (-0.5, -0.0). The reference serves them back to back:
    makespan 2.0 (the second op's ready time 0.5 is below the resource's
    availability 1.0)."""
    from repro.core.compile import MicroOps as JMicroOps
    from repro_torch.core import interop
    kw = dict(res=[1, 1], cls=[0, 0], nbytes=[0.0, 0.0], reqs=[0.0, 0.0],
              extra=[1.0, 1.0], nlat=[1.0, 0.0],
              deps=[[-1] * MAXD, [0] + [-1] * (MAXD - 1)], n_resources=2)
    ops = interop.micro_ops_from_arrays(**kw)
    jops = JMicroOps(**{k: getattr(ops, k) for k in (
        "res", "cls", "nbytes", "reqs", "extra", "nlat", "deps",
        "n_resources")})
    return ops, jops


def test_negative_lag_reaches_the_kernel_and_equals_the_reference(
        monkeypatch):
    from repro.core import jax_sim
    from repro.core.types import ServiceTimes as JST
    from repro_torch.core import torch_sim
    asked = _sentinel(monkeypatch)
    ops, jops = _two_ops_one_resource()
    for st in (T.PAPER_RAMDISK.replace(net_latency=-0.5),
               T.PAPER_RAMDISK.replace(net_latency=float("nan")),
               T.PAPER_RAMDISK):
        asked.clear()
        stats = t_engine.CacheStats()
        rep = torch_sim.simulate(ops, st, device="cpu", stats=stats)
        assert asked == [True]                   # the kernel was asked
        assert stats.kernel_fallbacks == 0
        want = jax_sim.simulate(jops, JST(**vars(st))).makespan
        assert repr(rep.makespan) == repr(float(want))
    neg = torch_sim.simulate(ops, T.PAPER_RAMDISK.replace(net_latency=-0.5),
                             device="cpu")
    assert neg.makespan == 2.0


@pytest.mark.parametrize("bad", ["negative_net_latency", "nan_storage",
                                 "negative_zero_lag"])
@pytest.mark.parametrize("knob", ["auto", "cuda"])
def test_engine_bucket_with_service_times_of_any_sign(monkeypatch, bad, knob):
    """Through the engine: every bucket asks for the kernel under both
    knobs, nothing falls back, and the makespans equal the reference's
    sweep (NaN where the reference's are)."""
    import repro.core as J
    from repro.core import workloads as JW
    asked = _sentinel(monkeypatch)
    st = {"negative_net_latency": T.PAPER_RAMDISK.replace(net_latency=-1e-4),
          "nan_storage": T.PAPER_RAMDISK.replace(storage=float("nan")),
          "negative_zero_lag": T.PAPER_RAMDISK.replace(net_latency=-0.0)}[bad]
    cands = T.grid(n_nodes=[6], chunk_sizes=[T.MB, 4 * T.MB])
    wfs = [TW.blast(c.n_app, n_queries=6, db_mb=8) for c in cands]
    cfgs = [c.to_config() for c in cands]
    with T.SweepSession(sim_engine=knob, device="cpu") as sess:
        got = sess.simulate_batch(wfs, cfgs, st=st)
        n_buckets = len(sess.engine.cache_keys())
        assert n_buckets >= 1 and asked == [True] * n_buckets
        assert sess.stats.kernel_fallbacks == 0
        assert sess.stats.kernel_buckets == n_buckets
    jc = J.grid(n_nodes=[6], chunk_sizes=[J.MB, 4 * J.MB])
    want = J.SweepSession(J.InlineBackend()).simulate_batch(
        [JW.blast(c.n_app, n_queries=6, db_mb=8) for c in jc],
        [c.to_config() for c in jc],
        st=J.ServiceTimes(**vars(st)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("value", [-0.5, -1e-300, -0.0, float("nan"),
                                   float("inf"), -float("inf")])
def test_plain_scan_equals_reference_kernel_on_any_value(value):
    """The semantics the CUDA kernel is held to on the card, for values
    no simulator run makes from sane service times: the plain version
    equals the reference's Pallas kernel (interpret mode) and its XLA
    oracle, with ``value`` at seeded places of dur and lag and every lag
    of one candidate made negative."""
    n_ops, n_cand, n_res = 48, 3, 4
    res, dur, lag, deps = random_bucket(n_ops, n_cand, n_res, 11)
    rng = np.random.default_rng(12)
    for arr in (dur, lag):
        arr[rng.integers(0, n_cand, 4), rng.integers(0, n_ops, 4)] = value
    lag[1] -= 0.05
    assert_all_equal((res, dur, lag, deps), n_res, block_rows=16)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device works")
    assert not t_ops.cuda_supported()
    with pytest.raises(RuntimeError, match="cuda"):
        T.SweepEngine()
    with pytest.raises(RuntimeError, match="cuda"):
        T.SweepSession()
    wf, cfg = TW.pipeline(2), T.partitioned_config(2, 2)
    ops = T.compile_workflow(wf, cfg)
    from repro_torch.core import torch_sim
    with pytest.raises(RuntimeError, match="cuda"):
        torch_sim.simulate(ops, T.PAPER_RAMDISK)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_sim.simulate_batch([ops], [T.PAPER_RAMDISK])
    with pytest.raises(RuntimeError, match="cuda"):
        T.Predictor(T.PAPER_RAMDISK).predict(wf, cfg, backend="scan")
    # and the same calls run when the CPU is asked for
    rep = T.Predictor(T.PAPER_RAMDISK, device="cpu").predict(wf, cfg,
                                                             backend="scan")
    assert rep.makespan > 0


# ---------------- the kernel's tile schedule, modelled on the CPU -------------------
#
# The CUDA kernel walks each candidate's chain in one thread while other
# warps stage the next tile and resolve its dependencies ahead of the
# chain (see the head note of csrc/sweep_scan.cu). The model below runs
# that schedule in Python: the stagers of tile k + 1 may read only end
# values the chain finished before tile k began, everything else is read
# by the chain from a window of the last two tiles, except what it owes
# to the row just before (a dep on that row, or that row's resource),
# which the chain forwards from registers. The chain issues a row's loads
# a step ahead, before the row before stores its fin and end, as the
# kernel does. End values the chain has not written yet are NaN, the
# max propagates NaN, and in the device-memory regime the window is a
# ring of two tiles, so a read outside what the kernel may read shows up
# in the result. Each candidate takes one of the kernel's two walks: the
# fast one when all its dur and lag are >= 0, else the general one (the
# 0.0 floor on avail, the row before's fin and end both kept when it is
# a dep on the same resource, a running makespan). The model computes in
# the float type of its inputs (NumPy scalars of f64 or f32, each + one
# correctly rounded operation of that type), as the kernel's two
# instantiations do.

def nmax(*vals):
    """max that propagates NaN (Python's max may drop it), in the type
    of its operands (all of one NumPy float type)."""
    return np.max(np.asarray(vals))


def tile_schedule_scan(res, dur, lag, deps, n_res, tile, ring):
    """Returns (makespan, end, counts): counts of the deps resolved by the
    stagers, read by the chain from the window, forwarded from the row
    before, and reading 0.0, and of the rows whose resource the chain
    forwards from the row before."""
    C, N = res.shape
    dt = dur.dtype
    zero = dt.type(0)
    mk = np.zeros(C, dt)
    end = np.zeros((C, N), dt)
    counts = {"stager": 0, "window": 0, "forward": 0, "zero": 0,
              "same_resource": 0}
    n_tiles = -(-N // tile)
    for c in range(C):
        general = not ((dur[c] >= 0).all() and (lag[c] >= 0).all())
        final = np.full(N, np.nan, dt)          # end values the chain wrote
        win = np.full(2 * tile if ring else N, np.nan, dt)
        avail = np.zeros(n_res, dt)
        walked = 0

        def stage(k):
            base, lo = k * tile, k * tile - tile
            assert walked >= max(lo, 0)        # the EMPTY barrier's promise
            rows = []
            for i in range(base, min(base + tile, N)):
                pre, slots, fwd = zero, [], False
                for d in deps[c, i]:
                    if d < 0 or d >= i:
                        counts["zero"] += 1
                    elif d == i - 1:
                        counts["forward"] += 1
                        fwd = True
                    elif d < lo:
                        counts["stager"] += 1
                        # the tile before the one being walked is still in
                        # the ring; below it the stagers copied ends out
                        if ring and d >= lo - tile:
                            assert copied[d] is None
                            pre = nmax(pre, win[d % (2 * tile)])
                        else:
                            pre = nmax(pre, copied[d] if ring else final[d])
                    else:
                        counts["window"] += 1
                        slots.append(d % (2 * tile) if ring else d)
                # the row before has this row's resource: the chain loads
                # the shared 0.0 for avail and forwards that row's fin
                same = bool(i > 0 and res[c, i - 1] == res[c, i])
                counts["same_resource"] += same
                rows.append((pre, slots, fwd, same))
            return rows

        def loads(rows, k, li):
            """What the chain loads for row li of tile k: the max of its
            window values, its resolved `pre` (and the shared 0.0) in a
            free slot, none when all MAXD slots read the window, and
            avail[res] (0.0 when it is forwarded), which the general walk
            floors at 0.0."""
            pre, slots, _, same = rows[li]
            av = zero if same else avail[res[c, k * tile + li]]
            if general:
                av = nmax(av, zero)
            free = [pre] if len(slots) < MAXD else []
            return nmax(av, *free, *(win[s] for s in slots))

        copied = [None] * N                     # ends the stagers copied out

        staged = stage(0)
        fin_last = l_last = mk_run = zero       # the chain's registers
        for k in range(n_tiles):
            if k >= 2:                          # tile k - 2, out of the ring
                for i in range((k - 2) * tile, (k - 1) * tile):
                    copied[i] = win[i % (2 * tile)] if ring else final[i]
            walking = staged
            if k + 1 < n_tiles:
                staged = stage(k + 1)           # while tile k is walked
            x = loads(walking, k, 0)
            for li, (_, _, fwd, same) in enumerate(walking):
                i = k * tile + li
                # row li + 1's loads go out before row li's stores
                x_next = (loads(walking, k, li + 1)
                          if li + 1 < len(walking) else None)
                # what start owes to the row just walked: its end (a dep
                # on it) or its fin (its resource); the fast walk keeps
                # only the end for both, as fin <= end when lag >= 0
                if general:
                    y = fin_last + l_last if fwd else fin_last
                    if fwd and same:
                        y = nmax(y, fin_last)
                else:
                    y = fin_last + (l_last if fwd else zero)
                fin = (nmax(x, y) if fwd or same else x) + dur[c, i]
                mk_run = nmax(mk_run, fin)
                avail[res[c, i]] = fin
                e = fin + lag[c, i]
                win[i % (2 * tile) if ring else i] = e
                final[i] = end[c, i] = e
                fin_last, l_last = fin, lag[c, i]
                x = x_next
                walked = i + 1
        # the fast walk's makespan: a resource's fin only grows, so the
        # max over the ops of fin is the max of the final avail; the
        # general walk keeps it running
        mk[c] = mk_run if general else nmax(zero, avail.max())
    return mk, end, counts


def assert_schedule_equal(arrays, n_res, tile):
    with enable_x64():
        mk_r, end_r = (np.asarray(v) for v in
                       j_sweep_scan_ref(*arrays, n_resources=n_res))
    counts = []
    for ring in (False, True):
        mk, end, n = tile_schedule_scan(*arrays, n_res, tile, ring)
        np.testing.assert_array_equal(mk, mk_r)
        np.testing.assert_array_equal(end, end_r)
        counts.append(n)
    assert counts[0] == counts[1]
    return counts[0]


@pytest.mark.parametrize("tile", [4, 8, t_kernel.TILE_ROWS])
@pytest.mark.parametrize("n_ops,n_cand,n_res,seed",
                         BOUNDARY + [(64, 4, 8, 64), (600, 4, 8, 600),
                                     (1024, 3, 8, 1024)])
def test_tile_schedule_matches_reference(n_ops, n_cand, n_res, seed, tile):
    """The kernel's schedule (stagers resolve what is final, the chain
    reads the two-tile window) on the boundary and multi-tile buckets, in
    both memory regimes, `np.array_equal` to the reference."""
    assert_schedule_equal(random_bucket(n_ops, n_cand, n_res, seed), n_res,
                          tile)


@pytest.mark.parametrize("n_ops,tile", [(40, 4), (100, 8), (37, 8),
                                        (1100, t_kernel.TILE_ROWS)])
def test_tile_schedule_on_adversarial_deps(n_ops, tile):
    """Deps at every hand-over point of the schedule: every kind (resolved
    by the stagers, read from the window, forwarded dep, forwarded
    resource, 0.0) is exercised and the result is the reference's to the
    bit."""
    arrays = adversarial_bucket(n_ops, 3, 5, n_ops, tile)
    counts = assert_schedule_equal(arrays, 5, tile)
    assert all(v > 0 for v in counts.values()), counts
    # and the plain version (what the kernel is held against on the card)
    mk_t, end_t = torch_ref(arrays, 5)
    with enable_x64():
        mk_r, end_r = j_sweep_scan_ref(*arrays, n_resources=5)
    np.testing.assert_array_equal(mk_t, np.asarray(mk_r))
    np.testing.assert_array_equal(end_t, np.asarray(end_r))


@pytest.mark.parametrize("value", [-0.5, -1e-300, -0.0, float("nan"),
                                   float("inf"), -float("inf")])
def test_tile_schedule_general_walk(value):
    """The general walk on the schedule's hand-over points: ``value`` at
    seeded places of dur and lag, one candidate's lags all negative, and
    one candidate left in the fast walk's range; equal to the plain
    version (NaN where it is NaN), in both memory regimes."""
    n_ops, tile = 100, 8
    res, dur, lag, deps = adversarial_bucket(n_ops, 4, 5, 3, tile)
    rng = np.random.default_rng(4)
    for arr in (dur, lag):
        arr[rng.integers(0, 3, 6), rng.integers(0, n_ops, 6)] = value
    lag[1] -= 0.05
    arrays = (res, dur, lag, deps)
    mk_t, end_t = torch_ref(arrays, 5)
    for ring in (False, True):
        mk, end, _ = tile_schedule_scan(*arrays, 5, tile, ring)
        np.testing.assert_array_equal(mk, mk_t)
        np.testing.assert_array_equal(end, end_t)
