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

# the CPU paths step through tiny tensors one op at a time, where
# PyTorch's intra-op thread pool costs more than it gives and fights
# the other test workers for cores
torch.set_num_threads(1)

MAXD = 4
# (n_ops, n_cand, n_res, seed): the boundary shapes of the reference's
# kernel tests, and its three multi-block rows (block_rows second)
BOUNDARY = [(1, 1, 1, 0), (7, 3, 4, 1), (8, 2, 8, 2), (9, 5, 3, 3),
            (19, 4, 6, 4)]
MULTI_BLOCK = [(64, 16), (64, 64), (128, 32)]


def random_bucket(n_ops, n_cand, n_res, seed):
    """A valid padded scan bucket: deps point strictly earlier or -1."""
    rng = np.random.default_rng(seed)
    res = rng.integers(0, n_res, (n_cand, n_ops), dtype=np.int32)
    dur = rng.uniform(0.01, 1.0, (n_cand, n_ops))
    lag = rng.uniform(0.0, 0.1, (n_cand, n_ops))
    deps = np.full((n_cand, n_ops, MAXD), -1, dtype=np.int32)
    for i in range(1, n_ops):
        k = int(rng.integers(0, MAXD + 1))
        if k:
            deps[:, i, :k] = rng.integers(0, i, (n_cand, k))
    return res, dur, lag, deps


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
    t_ops.reset_launch_count()
    t_ops.sweep_scan(*_tensors(), n_resources=4, use_kernel=True)
    t_ops.sweep_scan(*_tensors(), n_resources=4, use_kernel=False)
    assert t_ops.launch_count() == 0


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
    t_ops.reset_launch_count()
    with pytest.raises(t_build.KernelCompileError):
        t_ops.sweep_scan(*args, n_resources=4, use_kernel=True)
    assert t_ops.launch_count() == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(t_build, "nvcc_path", lambda: None)
    with pytest.raises(t_build.KernelCompileError, match="nvcc"):
        t_build.load_library("sweep_scan", [t_kernel.SOURCE],
                             t_kernel.EXTRA_FLAGS, build_dir=tmp_path)
    # the library name follows the source text and the flags
    a = t_build.library_path("k", [t_kernel.SOURCE], (), tmp_path)
    b = t_build.library_path("k", [t_kernel.SOURCE], ("-fmad=false",), tmp_path)
    assert a != b and a.parent == tmp_path


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
