"""Tests of the port that need a CUDA card and `nvcc`: they launch the
hand-written kernels (sweep_scan, flash_attention, ssd, moe_gmm), which
have no CPU mode.

Every test here carries the ``gpu`` marker and decides inside the test
whether a card is present, skipping with the reason when it is not. The
file imports `repro_torch` only, so it runs on a machine that has
PyTorch with CUDA and nothing of the reference's stack:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance for sweep_scan: none. The recurrence is `max` and `+` in f64,
so the kernel is `torch.equal` to its plain version (NaN equal to NaN,
for the inputs that make NaN), a sweep on the card equals the same
sweep on the CPU element for element, and the multi-process and sharded
backends on the card equal the inline one.
For flash_attention, ssd and moe_gmm: the reference's `_tol` (f32 1e-5,
bf16 2e-2), both sides computing in f32 in another order (moe_gmm's bf16
path rounds act to bf16 once); the SSD state at 1e-4 / 5e-2 as the
reference holds its own kernel.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import interop, ref_sim, torch_sim
from repro_torch.core import workloads as TW
from repro_torch.core.sweep.buckets import bucket_of
from repro_torch.core.sweep.engine import CacheStats
from repro_torch import configs as TC
from repro_torch.kernels.counts import KernelCounts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm.ref import expert_ffn_ref as gmm_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.sweep_scan import kernel as t_kernel
from repro_torch.kernels.sweep_scan import ops as t_ops
from repro_torch.models import forward, init

from torch_scan_buckets import adversarial_bucket, random_bucket

# (n_ops, n_cand, n_res, seed)
SHAPES = [(1, 1, 1, 0), (7, 3, 4, 1), (8, 2, 8, 2), (9, 5, 3, 3),
          (19, 4, 6, 4), (600, 4, 8, 9)]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
def test_kernel_equals_plain_version_on_the_card():
    """The CUDA kernel itself, in both memory regimes (`chip_smoke.py`
    runs the same comparison at more and larger shapes)."""
    need_card()
    for n_ops, n_cand, n_res, seed in SHAPES:
        args = [torch.from_numpy(a).cuda()
                for a in random_bucket(n_ops, n_cand, n_res, seed)]
        mk_p, end_p = t_ops.sweep_scan(*args, n_resources=n_res,
                                       use_kernel=False)
        base = t_kernel.load().sweep_scan_base_smem_bytes(n_res)
        for cap in (t_kernel.MAX_SMEM_BYTES, base):
            stats = CacheStats()
            mk_k, end_k = t_ops.sweep_scan(*args, n_resources=n_res,
                                           use_kernel=True, stats=stats,
                                           max_smem_bytes=cap)
            torch.cuda.synchronize()
            assert stats.kernel_launches == 1
            assert torch.equal(mk_k, mk_p) and torch.equal(end_k, end_p)


@pytest.mark.gpu
def test_sweep_on_the_card_equals_sweep_on_the_cpu():
    """The slice end to end: the same faulted grid through a CUDA
    session (kernel) and a CPU session (plain version)."""
    need_card()
    cands = T.grid(n_nodes=[6], chunk_sizes=[T.MB], replications=(1, 2),
                   faults=(None, T.parse_faults("disk=0:8,kill=1@40")))

    def workflow_for(c):
        return TW.blast(c.n_app, n_queries=6, db_mb=8)

    with T.SweepSession() as gpu, T.SweepSession(device="cpu") as cpu:
        eg = T.explore(workflow_for, cands, T.PAPER_RAMDISK, verify_top_k=2,
                       session=gpu)
        ec = T.explore(workflow_for, cands, T.PAPER_RAMDISK, verify_top_k=2,
                       session=cpu)
        assert gpu.device.type == "cuda"
        assert gpu.stats.kernel_buckets > 0
        assert gpu.stats.kernel_fallbacks == 0
        assert gpu.stats.kernel_launches > 0
        assert cpu.stats.kernel_launches == 0
    assert [e.index for e in eg] == [e.index for e in ec]
    assert [e.scan_makespan for e in eg] == [e.scan_makespan for e in ec]
    assert [e.makespan for e in eg] == [e.makespan for e in ec]


@pytest.mark.gpu
def test_batch_of_tenant_questions_equals_them_one_by_one():
    """Eight tenants' questions as the advisor's `tenants` traffic asks
    them (a partition of a 20-node BLAST cluster and a proper subset of
    its chunk sizes x stripe widths) on rows warmed by each partition's
    whole grid: ONE `explore_batch` call, its rows of one bucket in one
    launch, answers each question exactly as its own `explore` does."""
    need_card()
    st = T.PAPER_RAMDISK
    parts = (2, 5, 9, 14)
    grids = {n: T.grid(n_nodes=[20], partitions=[(n, 19 - n)],
                       chunk_sizes=[256 * 1024, T.MB, 4 * T.MB],
                       stripe_widths=(0, 1, 4)) for n in parts}
    wfs = {n: TW.blast(n, n_queries=12, db_mb=64) for n in parts}
    subsets = [(2, (0, 4, 8)), (5, (1, 2)), (9, (3, 5, 6, 7)), (14, (0,)),
               (2, (1, 3, 5, 7)), (5, (0, 4, 8)), (9, (2,)), (14, (6, 7, 8))]
    questions = [T.Question(lambda c, w=wfs[n]: w,
                            [grids[n][i] for i in idx], verify_top_k=0)
                 for n, idx in subsets]
    with T.SweepSession() as sess:
        for n in parts:                     # warm rows, as the cell's set-up
            T.explore(lambda c, w=wfs[n]: w, grids[n], st, verify_top_k=0,
                      session=sess)
        b0 = sess.stats.batch_calls
        one_by_one = [T.explore(q.workflow_for, q.candidates, st,
                                verify_top_k=0, session=sess)
                      for q in questions]
        b1, k1 = sess.stats.batch_calls, sess.stats.kernel_launches
        batched = T.explore_batch(questions, st, locality_aware=True,
                                  session=sess)
        assert (b1 - b0, sess.stats.batch_calls - b1) == (len(questions), 1)
        # one launch a bucket the questions touch, whoever asked
        buckets = {bucket_of(sess.compile_cache.get(q.workflow_for(c),
                                                    c.to_config()))
                   for q in questions for c in q.candidates}
        assert sess.stats.kernel_launches - k1 == len(buckets)
    for got, want in zip(batched, one_by_one):
        assert got == want
        assert np.array_equal([e.makespan for e in got],
                              [e.makespan for e in want])


@pytest.mark.gpu
def test_kernel_equals_plain_version_on_adversarial_deps():
    """Deps at every hand-over point of the warp-specialised schedule,
    over several tiles, in both memory regimes: `torch.equal`."""
    need_card()
    for n_ops, n_cand, n_res, seed in [(1100, 3, 5, 0), (2053, 2, 7, 1)]:
        args = [torch.from_numpy(a).cuda()
                for a in adversarial_bucket(n_ops, n_cand, n_res, seed,
                                              t_kernel.TILE_ROWS)]
        mk_p, end_p = t_ops.sweep_scan(*args, n_resources=n_res,
                                       use_kernel=False)
        base = t_kernel.load().sweep_scan_base_smem_bytes(n_res)
        for cap in (t_kernel.MAX_SMEM_BYTES, base):
            mk_k, end_k = t_ops.sweep_scan(*args, n_resources=n_res,
                                           use_kernel=True,
                                           max_smem_bytes=cap)
            torch.cuda.synchronize()
            assert torch.equal(mk_k, mk_p) and torch.equal(end_k, end_p)


def _same_values(a, b):
    """`torch.equal`, with NaN equal to NaN."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


@pytest.mark.gpu
@pytest.mark.parametrize("value", [-0.5, -1e-300, -0.0, float("nan"),
                                   float("inf"), -float("inf")])
def test_kernel_equals_plain_version_on_values_of_any_sign(value):
    """The kernel's general walk: ``value`` at seeded places of dur and
    lag of adversarial buckets, and every lag of one candidate negative,
    in both memory regimes: equal to the plain version, NaN where it is
    NaN."""
    need_card()
    for n_ops, n_cand, n_res, seed in [(600, 4, 8, 9), (1100, 3, 5, 0)]:
        res, dur, lag, deps = adversarial_bucket(n_ops, n_cand, n_res, seed,
                                                 t_kernel.TILE_ROWS)
        rng = np.random.default_rng(seed + 2)
        for arr in (dur, lag):
            arr[rng.integers(0, n_cand, 8), rng.integers(0, n_ops, 8)] = value
        lag[1] -= 0.05
        args = [torch.from_numpy(a).cuda() for a in (res, dur, lag, deps)]
        mk_p, end_p = t_ops.sweep_scan(*args, n_resources=n_res,
                                       use_kernel=False)
        base = t_kernel.load().sweep_scan_base_smem_bytes(n_res)
        for cap in (t_kernel.MAX_SMEM_BYTES, base):
            mk_k, end_k = t_ops.sweep_scan(*args, n_resources=n_res,
                                           use_kernel=True,
                                           max_smem_bytes=cap)
            torch.cuda.synchronize()
            assert _same_values(mk_k, mk_p) and _same_values(end_k, end_p)


@pytest.mark.gpu
@pytest.mark.parametrize("value", [None, -0.5, -1e-30, -0.0, float("nan"),
                                   float("inf"), -float("inf")])
def test_f32_kernel_equals_plain_version(value):
    """K1's f32 instantiation on boundary, multi-tile and adversarial
    buckets, in both memory regimes (their f32 caps): `torch.equal` to
    the plain version in f32, NaN where it is NaN; with ``value`` at
    seeded places of dur and lag and one candidate's lags negative (the
    general walk), or none (the fast walk)."""
    need_card()
    buckets = [adversarial_bucket(n, c, r, s, t_kernel.TILE_ROWS)
               for n, c, r, s in [(600, 4, 8, 9), (1100, 3, 5, 0)]]
    if value is None:
        buckets += [random_bucket(*shape) for shape in SHAPES]
    for res, dur, lag, deps in buckets:
        n_cand, n_ops = res.shape
        n_res = int(res.max()) + 1
        if value is not None:
            rng = np.random.default_rng(n_ops)
            for arr in (dur, lag):
                arr[rng.integers(0, n_cand, 8),
                    rng.integers(0, n_ops, 8)] = value
            lag[-1] -= 0.05
        args = [torch.from_numpy(res).cuda(),
                torch.from_numpy(dur).cuda().float(),
                torch.from_numpy(lag).cuda().float(),
                torch.from_numpy(deps).cuda()]
        mk_p, end_p = t_ops.sweep_scan(*args, n_resources=n_res,
                                       use_kernel=False)
        base = t_kernel.base_smem_bytes(n_res, torch.float32)
        for cap in (t_kernel.MAX_SMEM_BYTES, base):
            stats = CacheStats()
            mk_k, end_k = t_ops.sweep_scan(*args, n_resources=n_res,
                                           use_kernel=True, stats=stats,
                                           max_smem_bytes=cap)
            torch.cuda.synchronize()
            assert stats.kernel_launches == 1
            assert mk_k.dtype == end_k.dtype == torch.float32
            assert _same_values(mk_k, mk_p) and _same_values(end_k, end_p)


@pytest.mark.gpu
def test_f32_sweep_on_the_card_equals_sweep_on_the_cpu(monkeypatch):
    """``REPRO_SIM_X64=0`` end to end: the same faulted grid through a
    CUDA session (K1 in f32) and a CPU session (plain version in f32),
    exact verification included."""
    need_card()
    monkeypatch.setenv("REPRO_SIM_X64", "0")
    cands = T.grid(n_nodes=[6], chunk_sizes=[T.MB], replications=(1, 2),
                   faults=(None, T.parse_faults("disk=0:8,kill=1@40")))

    def workflow_for(c):
        return TW.blast(c.n_app, n_queries=6, db_mb=8)

    with T.SweepSession() as gpu, T.SweepSession(device="cpu") as cpu:
        eg = T.explore(workflow_for, cands, T.PAPER_RAMDISK, verify_top_k=2,
                       session=gpu)
        ec = T.explore(workflow_for, cands, T.PAPER_RAMDISK, verify_top_k=2,
                       session=cpu)
        assert gpu.stats.kernel_launches > 0
        assert gpu.stats.kernel_fallbacks == 0
        assert all(k[7] == torch.float32 for k in gpu.engine.cache_keys())
    assert [e.index for e in eg] == [e.index for e in ec]
    assert [e.scan_makespan for e in eg] == [e.scan_makespan for e in ec]
    assert [e.makespan for e in eg] == [e.makespan for e in ec]


@pytest.mark.gpu
def test_negative_net_latency_on_the_card_equals_the_plain_path():
    """Service times that make negative lags or NaN durations: every scan
    bucket launches the kernel under "auto" and "cuda" (no fallback) and
    equals the plain path on the CPU; the two-op case whose ready time
    falls below its resource's availability gives the reference's 2.0."""
    need_card()
    cands = T.grid(n_nodes=[6], chunk_sizes=[T.MB])
    st = T.PAPER_RAMDISK.replace(net_latency=-T.PAPER_RAMDISK.net_latency)

    def workflow_for(c):
        return TW.blast(c.n_app, n_queries=6, db_mb=8)

    with T.SweepSession(sim_engine="torch", device="cpu") as cpu:
        ec = T.explore(workflow_for, cands, st, verify_top_k=0, session=cpu)
    for knob in ("auto", "cuda"):
        with T.SweepSession(sim_engine=knob) as gpu:
            eg = T.explore(workflow_for, cands, st, verify_top_k=0,
                           session=gpu)
            assert gpu.stats.kernel_launches == gpu.stats.misses > 0
            assert gpu.stats.kernel_fallbacks == 0
        assert [e.makespan for e in eg] == [e.makespan for e in ec]
    ops = T.compile_workflow(workflow_for(cands[0]), cands[0].to_config())
    nan_st = T.PAPER_RAMDISK.replace(storage=float("nan"))
    stats = CacheStats()
    rep = torch_sim.simulate(ops, nan_st, stats=stats)
    assert stats.kernel_launches == 1 and stats.kernel_fallbacks == 0
    ref = torch_sim.simulate(ops, nan_st, device="cpu", use_kernel=False)
    assert repr(rep.makespan) == repr(ref.makespan)
    two = interop.micro_ops_from_arrays(
        res=[1, 1], cls=[0, 0], nbytes=[0.0, 0.0], reqs=[0.0, 0.0],
        extra=[1.0, 1.0], nlat=[1.0, 0.0], deps=[[-1] * 4, [0, -1, -1, -1]],
        n_resources=2)
    stats = CacheStats()
    rep = torch_sim.simulate(two, T.PAPER_RAMDISK.replace(net_latency=-0.5),
                             stats=stats)
    assert stats.kernel_launches == 1 and rep.makespan == 2.0


def _rows_by_key(engine):
    return {k: (a, f) for k, (_, a, f) in engine._rows.items()}


@pytest.mark.gpu
def test_rows_ordered_on_the_card_equal_the_host_rows(monkeypatch):
    """A CUDA engine orders every cold scan-mode row on the card
    (`torch_sim.estimated_order`), healthy and faulted, in f64 and f32: each
    row is `torch.equal` to the row the host path builds (the same
    engine with the order left to `scan_order`), and the makespans are
    a CPU engine's."""
    need_card()
    healthy = T.grid(n_nodes=[8], chunk_sizes=[256 * 1024, T.MB])
    faulted = T.grid(n_nodes=[8], chunk_sizes=[256 * 1024, T.MB],
                     replications=(1, 2),
                     faults=(T.parse_faults("disk=0:8,kill=1@1"),))
    ops = [T.compile_workflow(TW.blast(c.n_app, n_queries=12, db_mb=64),
                              c.to_config())
           for c in healthy + faulted]
    assert any(torch_sim.faulted(o) for o in ops)
    sts = [(T.PAPER_RAMDISK, T.PAPER_HDD)[i % 2] for i in range(len(ops))]
    card, cpu = T.SweepEngine(), T.SweepEngine(device="cpu")
    got = {dt: card.simulate_batch(ops, sts, dtype=dt)
           for dt in (torch.float64, torch.float32)}
    s = card.stats
    assert s.orders_on_card == s.row_misses == 2 * len(ops)
    assert s.orders_on_host == 0
    monkeypatch.setattr(torch_sim, "_orders_on_card", lambda dev: False)
    host = T.SweepEngine()
    for dt, mk in got.items():
        np.testing.assert_array_equal(mk, host.simulate_batch(ops, sts,
                                                              dtype=dt))
        np.testing.assert_array_equal(mk, cpu.simulate_batch(ops, sts,
                                                             dtype=dt))
    assert host.stats.orders_on_host == 2 * len(ops)
    rows, want = _rows_by_key(card), _rows_by_key(host)
    assert rows.keys() == want.keys()
    for k, (a, f) in rows.items():
        wa, wf = want[k]
        assert a.res.device.type == "cuda"
        for n in torch_sim.OpArrays._NAMES:
            assert torch.equal(getattr(a, n), getattr(wa, n)), n
        assert (f is None) == (wf is None)
        if f is not None:
            assert torch.equal(f.res_mult, wf.res_mult)
            assert torch.equal(f.dead, wf.dead)


def _largest_dags():
    """The largest DAG of each cell that orders cold rows: blast-s1 at
    n_app 18 and 256 KB (659,412 ops), the what-if cell's pipeline DSS
    at 256 KB (237,337 ops)."""
    (blast,) = T.grid([20], partitions=[(18, 1)], chunk_sizes=[256 * 1024])
    yield 659412, T.compile_workflow(
        TW.blast(18, n_queries=100, db_mb=1710), blast.to_config(),
        locality_aware=True)
    yield 237337, T.compile_workflow(
        TW.pipeline(wass=False),
        T.collocated_config(20, chunk_size=256 * 1024), locality_aware=False)


@pytest.mark.gpu
def test_relaxation_on_the_largest_dags_reaches_the_host_starts(monkeypatch):
    need_card()
    st = T.PAPER_RAMDISK
    for n_ops, ops in _largest_dags():
        assert ops.n_ops == n_ops
        dur = ref_sim.durations(ops, st) + ops.nlat * st.net_latency
        got = torch_sim._relax_starts(torch.tensor(ops.deps, device="cuda"),
                                      torch.tensor(dur, device="cuda"))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      torch_sim._scan_order_levels(ops, dur))
        card = torch_sim.estimated_order(ops, st, "cuda")
        with monkeypatch.context() as mp:
            mp.setattr(torch_sim, "_orders_on_card", lambda dev: False)
            host = torch_sim.estimated_order(ops, st, "cuda")
        assert card.on_card and not host.on_card
        assert torch.equal(card.perm, host.perm)
        np.testing.assert_array_equal(card.perm.cpu().numpy(),
                                      torch_sim.scan_order(ops, st))


def _backend_grid():
    cands = T.grid(n_nodes=[6], chunk_sizes=[512 * 1024, T.MB],
                   replications=(1, 2),
                   faults=(None, T.parse_faults("disk=0:8,kill=1@40")))

    def workflow_for(c):
        return TW.blast(c.n_app, n_queries=6, db_mb=8)
    return cands, workflow_for


@pytest.mark.gpu
def test_multiproc_workers_on_the_card_equal_inline(tmp_path):
    """Two worker processes, each on the card, launch K1 for their items:
    the sweep equals the inline one on the card, no item falls back, and
    the workers' kernel launches roll up into the parent's stats. The
    DAG cache is on disk, so a class whose verify item lands on the
    other worker is loaded there, not compiled again."""
    need_card()
    cands, workflow_for = _backend_grid()
    with T.SweepSession() as inline, \
            T.SweepSession(T.MultiprocBackend(2, item_timeout_s=600),
                           cache_dir=str(tmp_path)) as mp:
        ei = T.explore(workflow_for, cands, T.PAPER_RAMDISK, verify_top_k=2,
                       session=inline)
        em = T.explore(workflow_for, cands, T.PAPER_RAMDISK, verify_top_k=2,
                       session=mp)
        s = mp.stats
        assert mp.device.type == "cuda" and s.mp_items > 0
        assert s.mp_fallbacks == 0 and s.mp_late_drops == 0
        assert s.kernel_fallbacks == 0 and s.kernel_launches > 0
        assert sum(s.worker_rows.values()) == s.padded_rows
        assert sum(mp.compile_stats.worker_compiles.values()) == \
            mp.compile_stats.grid_classes
    assert [e.index for e in em] == [e.index for e in ei]
    assert [e.scan_makespan for e in em] == [e.scan_makespan for e in ei]
    assert [e.makespan for e in em] == [e.makespan for e in ei]


@pytest.mark.gpu
def test_sharded_on_two_slots_of_one_card_equals_inline():
    """A mesh naming the card twice splits every bucket in two, each half
    through K1: equal to the inline sweep to the bit. (It tests the
    split; it measures nothing about multi-GPU speed.)"""
    need_card()
    cands, workflow_for = _backend_grid()
    slots = [torch.device("cuda", 0)] * 2
    with T.SweepSession() as inline, T.SweepSession(
            T.ShardedBackend(slots, min_shard_oprows=0)) as sharded:
        ei = T.explore(workflow_for, cands, T.PAPER_RAMDISK, verify_top_k=2,
                       session=inline)
        es = T.explore(workflow_for, cands, T.PAPER_RAMDISK, verify_top_k=2,
                       session=sharded)
        s = sharded.stats
        assert sharded.engine.n_shards == 2 and s.sharded_batch_calls > 0
        assert set(s.device_rows) == {"cuda:0[0]", "cuda:0[1]"}
        assert s.kernel_fallbacks == 0
        # each split scan bucket launched K1 once per slot
        assert s.kernel_launches == 2 * inline.stats.kernel_launches > 0
    assert [e.index for e in es] == [e.index for e in ei]
    assert [e.makespan for e in es] == [e.makespan for e in ei]


# (B, S, H, K, hd, window): tests/test_kernels.py's rows, zamba2's
# request shape, a ragged length (S not a multiple of the 64-row tile),
# and the tensor-core kernel's edges: S = 200 with GQA 6:1 at hd 128,
# windows of 1 and 63 keys, mixtral's window 4096 at S = 4160, hd 80 at
# S = 100 without GQA
FA_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 128, 4, 4, 32, 0), (2, 256, 8, 2, 64, 64),
             (1, 512, 2, 1, 128, 128), (3, 192, 6, 3, 16, 0),
             (2, 512, 32, 32, 80, 0), (1, 100, 4, 2, 80, 7),
             (1, 200, 6, 1, 128, 0), (1, 300, 4, 2, 64, 1), (1, 300, 4, 2, 64, 63),
             (1, 4160, 12, 2, 128, 4096), (1, 100, 4, 4, 80, 0)]
# (B, S, H, P, N, chunk): tests/test_kernels.py's rows and zamba2's
SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 16, 8, 64),
              (2, 96, 3, 8, 4, 32), (1, 64, 8, 64, 32, 64),
              (2, 512, 80, 64, 64, 256)]


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_equals_plain_version(dtype):
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, K, hd, win in FA_SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
        want = fa_ops.flash_attention(q, k, v, window=win, use_kernel=False)
        counts = KernelCounts()
        got = fa_ops.flash_attention(q, k, v, window=win, use_kernel=True,
                                     counts=counts)
        torch.cuda.synchronize()
        assert counts == KernelCounts(flash_attention=1)
        torch.testing.assert_close(got.float(), want.float(), **tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_equals_plain_version(dtype):
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    for B, S, H, P, N, chunk in SSD_SHAPES:
        x = (randn(B, S, H, P) * 0.5).to(dtype)
        dt = torch.nn.functional.softplus(randn(B, S, H))
        a = torch.exp(torch.rand(H, generator=g, device="cuda"))
        b, c = ((randn(B, S, N) * 0.5).to(dtype) for _ in "bc")
        y0, h0 = ssd_ops.ssd(x, dt, a, b, c, chunk=chunk, use_kernel=False)
        counts = KernelCounts()
        y1, h1 = ssd_ops.ssd(x, dt, a, b, c, chunk=chunk, use_kernel=True,
                             counts=counts)
        torch.cuda.synchronize()
        assert counts == KernelCounts(ssd=1)
        torch.testing.assert_close(y1.float(), y0.float(), **tol(dtype))
        htol = dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16 \
            else dict(rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h1, h0, **htol)


# zamba2-2.7b's SSD at a long prompt (16 chunks a row, 1280 row-chunks:
# more than the card's 132 SMs hold at once) and at the request shape
SSD_ZAMBA2 = [(1, 4096, 80, 64, 64, 256), (8, 512, 80, 64, 64, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_ZAMBA2)
def test_ssd_kernel_at_zamba2_shapes(B, S, H, P, N, chunk, dtype):
    """The three-stage kernel (one launch counted) against the plain
    version at zamba2's widths, with zamba2's decay strength (A in
    [1, 16])."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = (randn(B, S, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H))
    a = 1.0 + 15.0 * torch.rand(H, generator=g, device="cuda")
    b, c = ((randn(B, S, N) * 0.5).to(dtype) for _ in "bc")
    y0, h0 = ssd_ops.ssd(x, dt, a, b, c, chunk=chunk, use_kernel=False)
    counts = KernelCounts()
    y1, h1 = ssd_ops.ssd(x, dt, a, b, c, chunk=chunk, use_kernel=True,
                         counts=counts)
    torch.cuda.synchronize()
    assert counts == KernelCounts(ssd=1)
    torch.testing.assert_close(y1.float(), y0.float(), **tol(dtype))
    htol = dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h1, h0, **htol)


@pytest.mark.gpu
def test_zamba2_forward_kernels_equal_plain_path_in_f32():
    """The reduced hybrid in f32 on the card: the kernel path (one K2
    launch per shared-block application, one K3 launch per Mamba2 layer)
    against the plain path."""
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TC.get("zamba2-2.7b").reduced().replace(dtype="float32")
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 64), device="cuda")
    plain = forward(params, toks, cfg, use_kernel=False)
    counts = KernelCounts()
    fast = forward(params, toks, cfg, use_kernel=True, counts=counts)
    torch.cuda.synchronize()
    assert counts == KernelCounts(
        flash_attention=cfg.n_layers // cfg.shared_attn_every,
        ssd=cfg.n_layers)
    torch.testing.assert_close(fast, plain, rtol=1e-4, atol=5e-4)


# (G, E, C, d, f): tests/test_kernels.py's moe_gmm rows (d = 16, f = 48
# among them), a capacity over 128 and no multiple of it, mixtral's decode
# capacity at full width, and the bf16 kernel's edges in C: 1, 65 (one past
# the 64-row tile) and 320 (qwen3-moe's capacity at 8 x 512)
GMM_SHAPES = [(1, 4, 64, 32, 64), (2, 2, 128, 64, 128), (1, 8, 32, 16, 48),
              (4, 2, 64, 128, 64), (1, 4, 136, 32, 64), (1, 8, 8, 6144, 16384),
              (1, 8, 1, 256, 512), (1, 8, 65, 512, 384), (1, 8, 320, 1024, 768)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_kernel_equals_plain_version(dtype):
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    for G, E, C, d, f in GMM_SHAPES:
        # unit tokens, weights at 1/sqrt(input width) as the model draws them
        x = torch.randn((G * E, C, d), generator=g, device="cuda").to(dtype)
        wg, wu, wd = (
            (torch.randn(shape, generator=g, device="cuda") / shape[1] ** 0.5)
            .to(dtype) for shape in ((E, d, f), (E, d, f), (E, f, d)))
        # f32: the plain version evaluated in f64, since its own f32
        # evaluation strays ~2e-5 from the exact sums at full width
        want = gmm_ops.expert_ffn(x, wg, wu, wd, use_kernel=False) \
            if dtype == torch.bfloat16 else gmm_ref(
                *(t.double() for t in (x, wg, wu, wd)))
        counts = KernelCounts()
        got = gmm_ops.expert_ffn(x, wg, wu, wd, use_kernel=True,
                                 counts=counts)
        torch.cuda.synchronize()
        assert counts == KernelCounts(moe_gmm=1)
        assert got.dtype == dtype and got.shape == x.shape
        torch.testing.assert_close(got.double(), want.double(),
                                   **tol(dtype))


@pytest.mark.gpu
def test_moe_gmm_bf16_kernel_is_deterministic():
    """The bf16 kernel sums over d and over f in one fixed order (no
    atomics): two calls on the same inputs give the same bits, with one
    consumer warpgroup (C <= 64) and with two."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    for G, E, C, d, f in [(1, 8, 8, 512, 1024), (2, 4, 320, 1024, 768)]:
        x = torch.randn((G * E, C, d), generator=g, device="cuda").bfloat16()
        wg, wu, wd = (
            (torch.randn(shape, generator=g, device="cuda") / shape[1] ** 0.5)
            .bfloat16() for shape in ((E, d, f), (E, d, f), (E, f, d)))
        first = gmm_ops.expert_ffn(x, wg, wu, wd, use_kernel=True)
        second = gmm_ops.expert_ffn(x, wg, wu, wd, use_kernel=True)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.gpu
def test_moe_gmm_raises_instead_of_falling_back():
    """A CUDA tensor the kernel cannot take raises; the plain version is
    never taken in its place, and nothing is counted."""
    need_card()
    x = torch.zeros(2, 8, 12, device="cuda")           # d = 12: no 16-byte rows
    w = torch.zeros(2, 12, 16, device="cuda")
    wd = torch.zeros(2, 16, 12, device="cuda")
    counts = KernelCounts()
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm_ops.expert_ffn(x, w, w, wd, use_kernel=True, counts=counts)
    assert counts == KernelCounts()


@pytest.mark.gpu
def test_mixtral_forward_kernels_equal_plain_path_in_f32():
    """The reduced MoE model in f32 on the card: one K2 and one K4
    launch per layer in prefill, one K4 launch per layer in a decode
    step, the logits of both paths equal within the model tolerance."""
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.models import init_decode_state
    from repro_torch.train.step import make_serve_step
    cfg = TC.get("mixtral-8x22b").reduced().replace(dtype="float32")
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 64), device="cuda")
    plain = forward(params, toks, cfg, use_kernel=False)
    counts = KernelCounts()
    fast = forward(params, toks, cfg, use_kernel=True, counts=counts)
    torch.cuda.synchronize()
    assert counts == KernelCounts(flash_attention=cfg.n_layers,
                                  moe_gmm=cfg.n_layers)
    torch.testing.assert_close(fast, plain, rtol=1e-4, atol=5e-4)
    state = init_decode_state(cfg, 2, 8, dtype=torch.float32)
    _, logits, state = make_serve_step(cfg, use_kernel=True, counts=counts)(
        params, state, toks[:, 0])
    torch.cuda.synchronize()
    assert counts == KernelCounts(flash_attention=cfg.n_layers,
                                  moe_gmm=2 * cfg.n_layers)
    torch.testing.assert_close(logits, plain[:, 0], rtol=1e-4, atol=5e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["granite-3-2b", "zamba2-2.7b"])
def test_train_step_on_the_card_equals_the_cpu(name):
    """One reduced f32 train step (plain paths, no TF32) on the card and
    on the CPU from the same parameters and batch: loss rtol 1e-5,
    grad_norm rtol 1e-4, updated parameters within 1e-6 + 1e-3 x lr for
    all but a share of 1e-3 of the elements and within 1e-6 + 2 x lr for
    every one (Adam's first step g / (|g| + eps) may take either sign
    where a gradient element is within rounding of zero;
    `tests/test_torch_train.py` holds the CPU to the reference the same
    way). No kernel launches in training."""
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.data import synth_batch
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import tree_map, tree_paths
    cfg = TC.get(name).reduced().replace(dtype="float32")
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in synth_batch(
        cfg, ShapeConfig("t", 64, 4, "train"),
        np.random.default_rng(0)).items()}
    opt = adamw.AdamWConfig(lr=1e-5, warmup_steps=1)
    counts = KernelCounts()
    step = make_train_step(cfg, opt, counts=counts)
    on_card = TrainState(params=tree_map(lambda t: t.cuda(), params),
                         opt=adamw.init(tree_map(lambda t: t.cuda(), params)))
    on_card, mc = step(on_card, tree_map(lambda t: t.cuda(), batch))
    on_cpu, mh = step(TrainState(params=params, opt=adamw.init(params)),
                      batch)
    torch.cuda.synchronize()
    assert counts == KernelCounts()
    np.testing.assert_allclose(float(mc["loss"]), float(mh["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mc["grad_norm"]),
                               float(mh["grad_norm"]), rtol=1e-4)
    lr = float(mh["lr"])
    diff = torch.cat([(a.cpu() - b).abs().ravel() for (_, a), (_, b) in
                      zip(tree_paths(on_card.params),
                          tree_paths(on_cpu.params))])
    assert float(diff.max()) <= 1e-6 + 2 * lr
    assert float((diff > 1e-6 + 1e-3 * lr).float().mean()) <= 1e-3


@pytest.mark.gpu
def test_checkpoint_round_trip_of_card_tensors(tmp_path):
    """A train state on the card saved through the store and restored
    onto the card: every leaf `torch.equal`, on the card, in its dtype."""
    need_card()
    from repro_torch.checkpoint import CheckpointManager, IntermediateStore
    from repro_torch.optim import adamw
    from repro_torch.train import TrainState
    from repro_torch.tree import tree_map, tree_paths
    cfg = TC.get("granite-3-2b").reduced()
    params = init(torch.Generator(device="cuda").manual_seed(1), cfg)
    state = TrainState(params=params, opt=adamw.init(params))
    state.opt.mu["embed"].normal_()
    mgr = CheckpointManager(root=str(tmp_path),
                            store=IntermediateStore(
                                str(tmp_path / "s"),
                                T.collocated_config(5, replication=2)),
                            n_writers=4)
    mgr.save(state, 5)
    like = TrainState(params=tree_map(torch.zeros_like, params),
                      opt=adamw.init(params))
    restored, step = mgr.restore(like, lost_nodes=[3])
    assert step == 5
    for (p, a), (q, b) in zip(tree_paths(restored), tree_paths(state)):
        assert p == q and a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b), p


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["zamba2-2.7b", "mixtral-8x22b"])
def test_mesh_forward_launches_kernels_inside_local_map(name):
    """On a (1, 1) NCCL mesh (one rank, every placement whole) the
    forward with DTensor parameters runs K2 and K3 (zamba2) or K2 and K4
    (mixtral) inside `local_map`: the same launches as without a mesh,
    the same logits at the f32 tolerance."""
    need_card()
    import socket

    import torch.distributed as dist
    from repro_torch.launch.elastic import resharded_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import param_specs, to_shardings
    from repro_torch.parallel.sharding import distribute

    cfg = TC.get(name).reduced().replace(dtype="float32")
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    toks = torch.randint(0, cfg.vocab, (2, 64), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    want_n = KernelCounts()
    want = forward(params, toks, cfg, use_kernel=True, remat=False,
                   counts=want_n)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        got_n = KernelCounts()
        got = forward(resharded_state(params, None, mesh,
                                      lambda m: param_specs(cfg, m)),
                      distribute(toks, to_shardings({"t": (("data",), None)},
                                                    mesh)["t"]),
                      cfg, use_kernel=True, remat=False, counts=got_n)
        got = got.full_tensor()
    finally:
        dist.destroy_process_group()
    assert got_n == want_n and got_n != KernelCounts(), (got_n, want_n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
