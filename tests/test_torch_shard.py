"""Device-sharded sweep execution in the port (repro_torch.core.sweep.shard),
a port of tests/test_shard.py.

The headline property: for any batch of workflows/configs, at any batch
size — including sizes that straddle the shard-count boundary —
`SweepEngine.simulate_batch` on a mesh is **element-wise identical** to
the one-device engine, in both scan and exact mode, and its scan
makespans equal the reference's to the bit.

The reference forces 8 host devices for its CPU leg; the port takes an
explicit mesh that names the one CPU device S times
(``[torch.device("cpu")] * S``), which exercises the same split, row
slicing and reassembly. Workflows are drawn from a seeded generator of
the same distribution as tests/test_core_sim.py's.
"""
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import workloads as JW

import repro_torch.core as T
from repro_torch.core import workloads as TW
from repro_torch.core.compile import compile_count, compile_workflow
from repro_torch.core.sweep import resolve_mesh, shard_count
from repro_torch.core.sweep.engine import MIN_SHARD_OPROWS
from repro_torch.core.sweep.shard import (make_candidates_mesh, mesh_identity,
                                          pow2_floor, shard_pad, slot_names)

torch.set_num_threads(1)

ST = T.PAPER_RAMDISK
CPU = torch.device("cpu")
SHARD_COUNTS = (2, 4, 8)


def cpu_mesh(n):
    return [CPU] * n


def random_workflow(P, rng: np.random.Generator):
    """tests/test_core_sim.py's `make_random_workflow`, for either
    package ``P`` (`repro.core` or `repro_torch.core`): the same seeded
    draws give the same workflow and config in both."""
    n_hosts = int(rng.integers(3, 7))
    n_tasks = int(rng.integers(1, 7))
    tasks, files = [], []
    for tid in range(n_tasks):
        n_in = int(rng.integers(0, min(2, len(files)) + 1))
        ins = tuple(rng.permutation(files)[:n_in]) if files else ()
        out = f"f{tid}"
        size = int(rng.integers(0, 5)) * 512 * 1024
        runtime = float(rng.uniform(0, 2))
        tasks.append(P.Task(tid=tid, inputs=ins, outputs=((out, size),),
                            runtime=runtime))
        files.append(out)
    cfg = P.collocated_config(
        n_hosts,
        chunk_size=[128 * 1024, 512 * 1024][int(rng.integers(0, 2))],
        replication=int(rng.integers(1, 3)),
        placement=[P.Placement.ROUND_ROBIN,
                   P.Placement.LOCAL][int(rng.integers(0, 2))])
    return P.Workflow(tasks=tasks, name="rand"), cfg


def random_pairs(P, seed, n):
    rng = np.random.default_rng(seed)
    return [random_workflow(P, rng) for _ in range(n)]


def blast_wf(W):
    return lambda c: W.blast(c.n_app, n_queries=6, db_mb=8, per_query_s=1.0)


def small_grid(P):
    return P.grid(n_nodes=[7], chunk_sizes=[512 * 1024, 1 * P.MB])


def plain_engine():
    return T.SweepEngine(device="cpu")


def sharded_engine(n, **kw):
    kw.setdefault("min_shard_oprows", 0)
    return T.SweepEngine(device="cpu", devices=cpu_mesh(n), **kw)


# ---------------- mesh resolution ------------------------------------------------

def test_pow2_floor():
    assert pow2_floor(0) == 0
    assert pow2_floor(1) == 1
    assert pow2_floor(6) == 4
    assert pow2_floor(8) == 8
    assert pow2_floor(9) == 8


def test_shard_pad_reuses_pow2_buckets():
    for n_shards in (1, 2, 8):
        for n in (1, 3, 7, 8, 9, 100):
            pad = shard_pad(n, n_shards)
            assert pad >= n and pad >= n_shards
            assert pad & (pad - 1) == 0          # a power of two
            assert pad % n_shards == 0           # always divides the mesh
    # within one shard group the bucket is stable: no new keys as the
    # batch grows up to the bucket size
    assert shard_pad(5, 8) == shard_pad(8, 8) == 8


def test_resolve_mesh_semantics():
    assert resolve_mesh(None, "cpu") is None
    assert resolve_mesh(0, "cpu") is None        # a CPU engine has one device
    assert resolve_mesh(1, "cpu") is None
    assert resolve_mesh(4, "cpu") is None
    with pytest.raises(ValueError):
        resolve_mesh(-1, "cpu")
    # explicit sequences: taken as given, floored to a power of two,
    # repeats allowed, one slot => no mesh
    assert resolve_mesh([CPU], "cpu") is None
    mesh = resolve_mesh(cpu_mesh(6), "cpu")
    assert mesh == (CPU,) * 4 and shard_count(mesh) == 4
    assert resolve_mesh(["cpu", "cpu"], "cpu") == (CPU, CPU)
    assert resolve_mesh(mesh, "cpu") == mesh     # a resolved mesh passes
    assert make_candidates_mesh(["cpu"] * 2) == (CPU, CPU)
    assert shard_count(None) == 1
    assert mesh_identity(None) is None
    assert mesh_identity(mesh) == mesh_identity(resolve_mesh(cpu_mesh(4),
                                                             "cpu"))
    assert mesh_identity(mesh) != mesh_identity(resolve_mesh(cpu_mesh(2),
                                                             "cpu"))
    # every slot of a mesh that repeats a device is named apart
    assert slot_names(mesh) == ["cpu[0]", "cpu[1]", "cpu[2]", "cpu[3]"]
    # a mesh holds devices of the engine's type only
    with pytest.raises(ValueError):
        resolve_mesh([CPU, CPU], "cuda")
    if not torch.cuda.is_available():
        # no card: asking for one raises, it never lands on the CPU
        with pytest.raises(RuntimeError):
            resolve_mesh(["cuda:0", "cuda:0"], "cuda")


def test_engine_reports_its_shards():
    plain = plain_engine()
    assert plain.n_shards == 1 and plain.mesh is None
    for n in SHARD_COUNTS:
        assert sharded_engine(n).n_shards == n
    assert T.SweepEngine(devices=0, device="cpu").n_shards == 1
    assert T.SweepEngine(devices=1, device="cpu").mesh is None
    # the reference's threshold, so placement and keys match its own
    assert MIN_SHARD_OPROWS == 32768
    assert plain.min_shard_oprows == MIN_SHARD_OPROWS


def test_adaptive_placement_policy():
    """Buckets below the op-row threshold stay on one device, larger
    ones split; an engine without a mesh never splits."""
    assert plain_engine().bucket_shards(8, 1 << 20) == 1
    eng = sharded_engine(8, min_shard_oprows=1024)
    assert eng.bucket_shards(3, 128) == 1            # 384 op-rows: too small
    assert eng.bucket_shards(8, 128) == 8            # 1024 op-rows: sharded
    assert eng.bucket_shards(1, 4096) == 8
    always = sharded_engine(8)
    assert always.bucket_shards(1, 16) == 8          # threshold 0: always
    default = T.SweepEngine(device="cpu", devices=cpu_mesh(2))
    assert default.bucket_shards(1, 16384) == 1
    assert default.bucket_shards(2, 16384) == 2


# ---------------- sharded == unsharded, bit-identical ------------------------------

@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_equals_unsharded_on_random_workflows(n_shards):
    """Batch sizes straddling the shard count, scan and exact mode."""
    plain, sharded = plain_engine(), sharded_engine(n_shards)
    sizes = sorted({1, n_shards - 1, n_shards, n_shards + 1})
    for size in sizes:
        pairs = random_pairs(T, 7000 + 31 * n_shards + size, size)
        ops = [compile_workflow(wf, cfg) for wf, cfg in pairs]
        for exact in (False, True):
            a = plain.simulate_batch(ops, [ST] * size, exact=exact)
            b = sharded.simulate_batch(ops, [ST] * size, exact=exact)
            np.testing.assert_array_equal(a, b)
    assert sharded.stats.sharded_batch_calls > 0
    assert any(k[4] == n_shards for k in sharded.cache_keys())


def test_sharded_grid_sweep_equals_reference():
    """The same property on a real decision grid (heterogeneous
    buckets), and the scan makespans equal the reference's engine."""
    tc, jc = small_grid(T), small_grid(J)
    tops = [compile_workflow(blast_wf(TW)(c), c.to_config()) for c in tc]
    jops = [J.compile_workflow(blast_wf(JW)(c), c.to_config()) for c in jc]
    want = J.SweepEngine().simulate_batch(jops, [J.PAPER_RAMDISK] * len(jops))
    plain, sharded = plain_engine(), sharded_engine(4)
    np.testing.assert_array_equal(plain.simulate_batch(tops, [ST] * len(tops)),
                                  want)
    np.testing.assert_array_equal(
        sharded.simulate_batch(tops, [ST] * len(tops)), want)
    for size in (1, 3, 4, 5):
        sub = (tops * ((size // len(tops)) + 1))[:size]
        np.testing.assert_array_equal(plain.simulate_batch(sub, [ST] * size),
                                      sharded.simulate_batch(sub, [ST] * size))


def test_explore_sharded_bit_identical():
    """The legacy ``devices=`` kwarg on `explore` picks the sharded
    backend and changes no result, ranking or verification."""
    cands = small_grid(T)
    eng = T.SweepEngine(device="cpu", min_shard_oprows=0)
    on = T.explore(blast_wf(TW), cands, ST, verify_top_k=2, engine=eng,
                   compile_cache=T.CompileCache(), devices=cpu_mesh(2))
    off = T.explore(blast_wf(TW), cands, ST, verify_top_k=2,
                    engine=plain_engine(), compile_cache=T.CompileCache())
    assert eng.n_shards == 2 and eng.stats.sharded_batch_calls > 0
    assert [e.index for e in on] == [e.index for e in off]
    np.testing.assert_array_equal([e.makespan for e in on],
                                  [e.makespan for e in off])
    assert [e.verified for e in on] == [e.verified for e in off]


# ---------------- key stability ----------------------------------------------------

def test_growing_batch_within_bucket_is_key_stable():
    """Counter-asserted: growing the batch inside one (ops, resources,
    batch) bucket while sharded makes no new key and runs no
    `compile_workflow`."""
    eng = sharded_engine(4)
    c = small_grid(T)[0]
    ops = compile_workflow(blast_wf(TW)(c), c.to_config())
    top = 8                                       # the shared batch bucket
    sizes = list(range(top // 2 + 1, top + 1))    # all bucket to `top`
    eng.simulate_batch([ops] * sizes[-1], [ST] * sizes[-1])
    misses = eng.stats.misses
    assert misses >= 1
    n0 = compile_count()
    for k in sizes:
        eng.simulate_batch([ops] * k, [ST] * k)
    assert eng.stats.misses == misses             # zero new callables
    assert eng.stats.hits >= len(sizes)
    assert compile_count() == n0


def test_set_mesh_drops_stale_sharded_callables():
    eng = sharded_engine(2)
    c = small_grid(T)[0]
    ops = compile_workflow(blast_wf(TW)(c), c.to_config())
    want = eng.simulate_batch([ops] * 3, [ST] * 3)
    assert any(k[4] == 2 for k in eng.cache_keys())
    # shards=1 entries survive a mesh change, sharded ones are dropped
    eng.min_shard_oprows = 1 << 40
    eng.simulate_batch([ops] * 3, [ST] * 3)
    assert any(k[4] == 1 for k in eng.cache_keys())
    eng.min_shard_oprows = 0
    eng.set_mesh(resolve_mesh(cpu_mesh(4), "cpu"))
    assert eng.n_shards == 4
    assert all(k[4] == 1 for k in eng.cache_keys()) and eng.cache_keys()
    np.testing.assert_array_equal(want, eng.simulate_batch([ops] * 3,
                                                           [ST] * 3))
    eng.set_mesh(resolve_mesh(None, "cpu"))
    assert eng.n_shards == 1 and eng.mesh is None
    assert all(k[4] == 1 for k in eng.cache_keys())
    got = eng.simulate_batch([ops] * 3, [ST] * 3)
    np.testing.assert_array_equal(want, got)
    # a no-op re-point keeps the cache
    keys = eng.cache_keys()
    eng.set_mesh(resolve_mesh(None, "cpu"))
    assert eng.cache_keys() == keys


# ---------------- counters ---------------------------------------------------------

def test_per_device_placement_counters():
    for n in SHARD_COUNTS:
        eng = sharded_engine(n)
        c = small_grid(T)[0]
        k = 2 * n + 1                             # odd: forces remainder padding
        ops = [compile_workflow(blast_wf(TW)(c), c.to_config())] * k
        eng.simulate_batch(ops, [ST] * k)
        assert eng.stats.sharded_batch_calls == 1
        assert len(eng.stats.device_rows) == n    # every slot counted apart
        rows = set(eng.stats.device_rows.values())
        assert len(rows) == 1                     # even split across the mesh
        assert sum(eng.stats.device_rows.values()) == eng.stats.padded_rows
        assert eng.stats.sims == k
        eng.stats.reset()
        assert eng.stats.device_rows == {}
    plain = plain_engine()
    plain.simulate_batch(ops, [ST] * len(ops))
    assert plain.stats.sharded_batch_calls == 0
    assert plain.stats.device_rows == {}
