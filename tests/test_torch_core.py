"""Parity of the port's backend-neutral core with the reference.

The same workflow and configuration, described once, go through
`repro.core` and `repro_torch.core`: fingerprints, every compiled
`MicroOps` array, the DES oracle's makespan and the scan-order
permutation must be equal — healthy and under a fault scenario, with
replication 1 and 2. Trace fixtures are parsed by each package's own
readers (`repro.core.trace`, `repro_torch.core.trace`). Also pinned: the
port imports neither `jax` nor `repro`.
"""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import jax_sim, ref_sim as j_ref, workloads as JW
from repro.core.trace import load_trace, to_workflow

import repro_torch
import repro_torch.core as T
from repro_torch.core import interop, ref_sim as t_ref, torch_sim
from repro_torch.core import workloads as TW

# the CPU paths step through tiny tensors one op at a time, where
# PyTorch's intra-op thread pool costs more than it gives and fights
# the other test workers for cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRACES = ROOT / "examples" / "traces"
FIXTURES = ["montage_small.json", "blast_small.json", "cycles_small.dax"]
FAULT_SPEC = "disk=0:8,kill=1@40"
ARRAYS = ("res", "cls", "nbytes", "reqs", "extra", "nlat", "deps",
          "res_mult", "dead")

MAKERS = {
    "pipeline": lambda W: W.pipeline(4),
    "reduce": lambda W: W.reduce_(4),
    "broadcast": lambda W: W.broadcast(4),
    "scatter_gather": lambda W: W.scatter_gather(4, in_mb=32, shard_mb=8,
                                                 out_mb=2),
    "map_reduce_shuffle": lambda W: W.map_reduce_shuffle(4, 3, in_mb=8,
                                                         part_mb=1, out_mb=4),
    "blast": lambda W: W.blast(4, n_queries=24, db_mb=64),
}
WORKLOADS = list(MAKERS) + FIXTURES
SCENARIOS = [("healthy", 1), ("healthy", 2), ("faulted", 1), ("faulted", 2)]


def workflow_pair(name):
    """(reference workflow, port workflow) for one workload name."""
    if name in MAKERS:
        return MAKERS[name](JW), MAKERS[name](TW)
    jwf = to_workflow(load_trace(TRACES / name))
    return jwf, T.trace.to_workflow(T.trace.load_trace(TRACES / name))


def config_pair(scenario, replication):
    faults = J.parse_faults(FAULT_SPEC) if scenario == "faulted" else None
    jcfg = J.partitioned_config(4, 3, chunk_size=512 * 1024,
                                replication=replication, faults=faults)
    tfaults = T.parse_faults(FAULT_SPEC) if scenario == "faulted" else None
    tcfg = T.partitioned_config(4, 3, chunk_size=512 * 1024,
                                replication=replication, faults=tfaults)
    return jcfg, tcfg


def assert_same_micro_ops(jo, to):
    """Every array (values and dtype) and every piece of metadata."""
    assert jo.n_resources == to.n_resources
    for f in ARRAYS:
        a, b = getattr(jo, f), getattr(to, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert jo.task_end_op == to.task_end_op
    assert jo.stage_of_task == to.stage_of_task
    assert jo.file_write_op == to.file_write_op
    assert (jo.bytes_moved, jo.storage_used) == (to.bytes_moved,
                                                 to.storage_used)


@pytest.mark.parametrize("scenario,replication", SCENARIOS)
@pytest.mark.parametrize("name", WORKLOADS)
def test_compile_and_oracle_parity(name, scenario, replication):
    jwf, twf = workflow_pair(name)
    jcfg, tcfg = config_pair(scenario, replication)
    assert jwf.fingerprint() == twf.fingerprint()
    assert jcfg.fingerprint() == tcfg.fingerprint()
    # the config also survives the dict hand-over, fault scenario included
    carried = interop.storage_config_from_dict(dataclasses.asdict(jcfg))
    assert carried.fingerprint() == tcfg.fingerprint()
    assert carried == tcfg

    jo = J.compile_workflow(jwf, jcfg)
    to = T.compile_workflow(twf, tcfg)
    assert_same_micro_ops(jo, to)

    rj = j_ref.simulate(jo, J.PAPER_RAMDISK)
    rt = t_ref.simulate(to, T.PAPER_RAMDISK)
    assert rj.makespan == rt.makespan
    assert rj.per_task_end == rt.per_task_end
    assert rj.failed == rt.failed

    pj = jax_sim.scan_order(jo, J.PAPER_RAMDISK)
    pt = torch_sim.scan_order(to, T.PAPER_RAMDISK)
    assert pj.dtype == pt.dtype
    np.testing.assert_array_equal(pj, pt)


def odd_sizes(P):
    """Files of no bytes and files whose last chunk is partial, and a task
    whose start barrier holds more than MAXD deps, most of them on
    preloaded files (no op: ``-1``), on fixed clients."""
    ck = 512 * P.KB
    local = P.FileAttr(placement=P.Placement.LOCAL)
    pre = {"in": (5 * ck + 123, None), "empty": (0, None)}
    pre.update({f"p{k}": ((k + 1) * ck // 3, None) for k in range(9)})
    tasks = [
        P.Task(tid=0, inputs=("in", "empty"), client=1, stage="a", runtime=0.5,
               outputs=(("mid", 3 * ck + 1), ("zero", 0)),
               file_attrs={"mid": local}),
        P.Task(tid=1, inputs=("mid", "zero"), client=1, stage="b",
               outputs=(("part", ck - 1),)),
        P.Task(tid=2, inputs=("part", "p0", "p1", "p2", "p3", "zero", "p4",
                              "p5", "p6", "p7", "p8", "mid"),
               client=1, stage="c", outputs=(("out", 7 * ck + 5),)),
    ]
    return P.Workflow(tasks=tasks, name="odd_sizes", preloaded=pre)


def whatif_pattern(pattern, args, locality_aware, chunk_size):
    """A deployment of the what-if benchmark's patterns: 19 clients
    collocated with storage on 20 hosts, the medium-scale files."""
    def build(P, W):
        return (getattr(W, pattern)(**args),
                P.collocated_config(20, chunk_size=chunk_size),
                locality_aware)
    return build


def blast_faulted(spec, replication):
    def build(P, W):
        return (W.blast(4, n_queries=24, db_mb=64),
                P.partitioned_config(4, 3, chunk_size=256 * P.KB,
                                     replication=replication,
                                     faults=P.parse_faults(spec)), True)
    return build


# the block emitter's inputs: whole-width reads, local and remote chunk
# chains, replica chains of 1, 2 and 4, failover and steering, dead ops
CORPUS = {
    "blast_paper_db_256k": lambda P, W: (
        W.blast(4, n_queries=24, db_mb=1710),
        P.partitioned_config(4, 3, chunk_size=256 * P.KB), True),
    **{f"{name}_{ck // 1024}k": whatif_pattern(pattern, args, la, ck)
       for name, pattern, args, la in [
           ("pipeline_dss", "pipeline", {"wass": False}, False),
           ("pipeline_wass", "pipeline", {"wass": True}, True),
           ("reduce_dss", "reduce_", {"wass": False}, False),
           ("reduce_wass", "reduce_", {"wass": True}, True),
           ("broadcast_r1", "broadcast", {"replication": 1}, False),
           ("broadcast_r2", "broadcast", {"replication": 2}, True),
           ("broadcast_r4", "broadcast", {"replication": 4}, True)]
       for ck in (256 * 1024, 4 * 1024 * 1024)},
    # a host killed after two tasks and another degraded: reads fail over
    # and steer to the healthy replica
    "blast_failover_r2": blast_faulted("disk=0:8,kill=1@2", 2),
    "pipeline_failover_r2": lambda P, W: (
        W.pipeline(4), P.partitioned_config(
            4, 3, chunk_size=512 * P.KB, replication=2,
            faults=P.parse_faults("disk=2:4,kill=1@5")), True),
    # no surviving replica: lost reads; then no live storage: lost writes
    "blast_lost_reads_r1": blast_faulted("kill=1@2", 1),
    "blast_all_storage_dead": blast_faulted("kill=0@2,kill=1@2,kill=2@3", 2),
    "odd_sizes": lambda P, W: (odd_sizes(P), P.collocated_config(
        4, chunk_size=512 * P.KB, replication=2), True),
    "odd_sizes_faulted": lambda P, W: (odd_sizes(P), P.collocated_config(
        4, chunk_size=512 * P.KB, replication=2,
        faults=P.parse_faults("kill=0@1,disk=1:3")), True),
}


PROFILES = ("PAPER_RAMDISK", "PAPER_HDD")


def card_order(ops, st_ref):
    """`torch_sim.estimated_order` with the card's path run on CPU
    tensors (`_orders_on_card` patched)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_sim, "_orders_on_card", lambda dev: True)
        return torch_sim.estimated_order(ops, st_ref, "cpu")


def assert_device_order_is_host_order(jo, to):
    """The card's order, run on CPU tensors, orders the DAG as the
    reference's `scan_order` and the port's host one do, under both
    paper profiles."""
    for p in PROFILES:
        order = card_order(to, getattr(T, p))
        assert order.on_card, p
        assert order.perm.dtype == torch.int64
        got, want = order.perm.numpy(), jax_sim.scan_order(jo, getattr(J, p))
        np.testing.assert_array_equal(got, want, err_msg=p)
        np.testing.assert_array_equal(
            got, torch_sim.scan_order(to, getattr(T, p)), err_msg=p)


def reference_ops(to):
    """The reference's `MicroOps` over the port's arrays."""
    return J.MicroOps(**{f: getattr(to, f) for f in ARRAYS},
                      n_resources=to.n_resources)


@pytest.mark.parametrize("name", list(CORPUS))
def test_compile_parity_corpus(name):
    """The port's block emitter builds the reference's DAG, to the bit,
    and the device orders it as the host does."""
    jwf, jcfg, la = CORPUS[name](J, JW)
    twf, tcfg, _ = CORPUS[name](T, TW)
    assert jwf.fingerprint() == twf.fingerprint()
    assert jcfg.fingerprint() == tcfg.fingerprint()
    counts = {}
    to = T.compile_workflow(twf, tcfg, locality_aware=la, counts=counts)
    jo = J.compile_workflow(jwf, jcfg, locality_aware=la)
    assert_same_micro_ops(jo, to)
    assert 0 < counts["bulk_ops"] < to.n_ops
    for f in ARRAYS:
        a = getattr(to, f)
        assert a is None or a.flags.c_contiguous, f
    assert_device_order_is_host_order(jo, to)


@pytest.mark.parametrize("name", WORKLOADS)
def test_scan_order_levels_equal_loop(name):
    """The level-wise NumPy forward pass and the op-by-op loop give the
    same estimated starts, to the bit (same max and + per op), and the
    device's relaxation the same order."""
    _, twf = workflow_pair(name)
    _, tcfg = config_pair("faulted", 2)
    ops = T.compile_workflow(twf, tcfg)
    dur = t_ref.durations(ops, T.PAPER_HDD) + ops.nlat * T.PAPER_HDD.net_latency
    np.testing.assert_array_equal(torch_sim._scan_order_levels(ops, dur),
                                  torch_sim._scan_order_loop(ops, dur))
    assert_device_order_is_host_order(reference_ops(ops), ops)


@pytest.mark.parametrize("n_app", [2, 3, 4, 5])
def test_device_order_on_faulted_blast(n_app):
    """Small BLAST jobs with storage rank 1 lost before each task in turn
    (and never) beside a disk 8x slow on rank 0, at replication 1 and 2."""
    for kill in [None, *range(n_app + 1)]:
        faults = T.FaultScenario(
            failures=(T.NodeFailure(1, after_tasks=kill),),
            degraded=(T.DiskDegradation(0, 8.0),))
        for r in (1, 2):
            cfg = T.partitioned_config(n_app, 3, chunk_size=512 * 1024,
                                       replication=r, faults=faults)
            ops = T.compile_workflow(
                TW.blast(n_app, n_queries=12, db_mb=16), cfg)
            assert torch_sim.faulted(ops)
            assert_device_order_is_host_order(reference_ops(ops), ops)


def row_case(name):
    """(reference MicroOps, port MicroOps): BLAST healthy, or the
    pipeline under `FAULT_SPEC`, at replication 2."""
    jwf, twf = workflow_pair(name)
    jcfg, tcfg = config_pair("faulted" if name == "pipeline" else "healthy",
                             2)
    return J.compile_workflow(jwf, jcfg), T.compile_workflow(twf, tcfg)


def order_from(source, ops, st):
    """The port's `DeviceOrder` of ``ops`` on CPU tensors, its order
    from ``source``: op order (exact mode), the host's `scan_order`, or
    the card's relaxation."""
    if source == "exact":
        order = torch_sim.estimated_order(ops, None, "cpu")
    elif source == "host":
        order = torch_sim.estimated_order(ops, st, "cpu")
    else:
        order = card_order(ops, st)
    assert order.on_card == (source == "card")
    return order


def assert_rows_equal_reference(order, jo, perm, pad, r_pad):
    """Every field of ``order.arrays(pad, r_pad)`` holds the values of
    the reference's `OpArrays` and `FaultArrays` for ``perm``, in the
    reference's dtype (``cls`` is i64 here: an index tensor)."""
    arr, farr = order.arrays(pad, r_pad)
    want = jax_sim.OpArrays.from_micro_ops(jo, pad, perm=perm)
    for f in torch_sim.OpArrays._NAMES:
        a, b = getattr(arr, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == (np.int64 if f == "cls" else b.dtype), f
        assert a.shape == b.shape and np.array_equal(a, b), f
    assert (farr is None) == (not jax_sim.faulted(jo))
    if farr is not None:
        fwant = jax_sim.FaultArrays.from_micro_ops(jo, r_pad, pad, perm=perm)
        for f in torch_sim.FaultArrays._NAMES:
            a, b = getattr(farr, f).numpy(), np.asarray(getattr(fwant, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("source", ["exact", "host", "card"])
@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("name", ["blast", "pipeline"])
def test_rows_equal_reference_rows(name, x64, source, monkeypatch):
    """`DeviceOrder.arrays`, the one row builder, permutes, renumbers,
    pads and rounds a DAG's rows as the reference's
    `OpArrays.from_micro_ops` / `FaultArrays.from_micro_ops` do under
    the same permutation, whichever source ordered them, in f64 and in
    f32 (``REPRO_SIM_X64=0``), unpadded and padded; the order is the
    reference's `scan_order` (op order in exact mode)."""
    monkeypatch.setenv("REPRO_SIM_X64", "1" if x64 else "0")
    jo, to = row_case(name)
    order = order_from(source, to, T.PAPER_HDD)
    perm = None if source == "exact" else jax_sim.scan_order(jo, J.PAPER_HDD)
    np.testing.assert_array_equal(
        order.perm.numpy(), np.arange(to.n_ops) if perm is None else perm)
    arr, _ = order.arrays()
    assert arr.nbytes.dtype == (torch.float64 if x64 else torch.float32)
    for pad, r_pad in ((None, None), (1 << to.n_ops.bit_length(),
                                      to.n_resources + 5)):
        assert_rows_equal_reference(order, jo, perm, pad, r_pad)


def test_empty_dag_rows_equal_reference_rows():
    """A DAG with no ops gets an empty order from every source, and
    rows (all padding when padded) equal to the reference's."""
    _, to = row_case("pipeline")
    to = dataclasses.replace(to, dead=np.zeros(0), **{
        f: getattr(to, f)[:0] for f in ("res", "cls", "nbytes", "reqs",
                                        "extra", "nlat", "deps")})
    assert torch_sim.faulted(to)
    jo = reference_ops(to)
    for source in ("exact", "host", "card"):
        order = order_from(source, to, T.PAPER_HDD)
        assert order.perm.shape == (0,)
        for pad, r_pad in ((None, None), (8, to.n_resources + 1)):
            assert_rows_equal_reference(order, jo, None, pad, r_pad)


def small_blast(forward_dep=False):
    to = T.compile_workflow(TW.blast(3, n_queries=12, db_mb=16),
                            T.partitioned_config(3, 3, chunk_size=T.MB))
    if not forward_dep:
        return to
    deps = to.deps.copy()
    deps[2, 0] = to.n_ops - 1                      # forward reference
    return dataclasses.replace(to, deps=deps)


@pytest.mark.parametrize("case", ["plain", "forward_dep", "non_finite"])
def test_engine_orders_on_the_device_unless_the_dag_forbids(case,
                                                            monkeypatch):
    """With rows ordered on the device (here a CPU standing in for the
    card), a DAG with a forward dep or a duration that is not finite
    takes the host path and counts in ``orders_on_host``; the rows, and
    so the makespans, are the host path's either way."""
    ops = small_blast(forward_dep=case == "forward_dep")
    st = (T.PAPER_RAMDISK.replace(storage=float("inf"))
          if case == "non_finite" else T.PAPER_RAMDISK)
    host = T.SweepEngine(device="cpu")
    want = host.simulate_batch([ops], [st])
    monkeypatch.setattr(torch_sim, "_orders_on_card", lambda dev: True)
    on_card = torch_sim.estimated_order(ops, st, "cpu").on_card
    assert on_card == (case == "plain")
    eng = T.SweepEngine(device="cpu")
    got = eng.simulate_batch([ops], [st])
    np.testing.assert_array_equal(got, want)
    (b, _), = eng.cached_batches()
    (hb, _), = host.cached_batches()
    for f in torch_sim.OpArrays._NAMES:
        assert torch.equal(getattr(b, f), getattr(hb, f)), f
    s = eng.stats
    assert (s.orders_on_card, s.orders_on_host) == (int(on_card),
                                                    int(not on_card))
    assert s.orders_on_card + s.orders_on_host == s.row_misses == 1
    assert (host.stats.orders_on_card, host.stats.orders_on_host) == (0, 1)
    eng.simulate_batch([ops], [st], exact=True)     # exact mode orders nothing
    assert s.orders_on_card + s.orders_on_host == 1 < s.row_misses


def test_scan_order_forward_dep_takes_the_loop():
    """A dep that points at a later op reads 0.0 in the reference's
    loop; the port must not send such a DAG down the level-wise path."""
    jo = J.compile_workflow(JW.pipeline(3), J.partitioned_config(3, 2))
    deps = jo.deps.copy()
    deps[2, 0] = jo.n_ops - 1                      # forward reference
    jo = dataclasses.replace(jo, deps=deps)
    to = interop.micro_ops_from_arrays(
        **{f: getattr(jo, f) for f in ARRAYS}, n_resources=jo.n_resources)
    np.testing.assert_array_equal(jax_sim.scan_order(jo, J.PAPER_RAMDISK),
                                  torch_sim.scan_order(to, T.PAPER_RAMDISK))


def test_interop_micro_ops_and_service_times():
    jwf, _ = workflow_pair("blast")
    jcfg, tcfg = config_pair("faulted", 2)
    jo = J.compile_workflow(jwf, jcfg)
    to = interop.micro_ops_from_arrays(
        **{f: getattr(jo, f) for f in ARRAYS}, n_resources=jo.n_resources,
        task_end_op=jo.task_end_op, stage_of_task=jo.stage_of_task,
        file_write_op=jo.file_write_op, bytes_moved=jo.bytes_moved,
        storage_used=jo.storage_used)
    st = interop.service_times_from_dict(dataclasses.asdict(J.PAPER_HDD))
    assert st == T.PAPER_HDD
    assert to.cls.dtype == np.int8 and to.deps.dtype == np.int32
    rj = j_ref.simulate(jo, J.PAPER_HDD)
    rt = t_ref.simulate(to, st)
    assert rj.makespan == rt.makespan and rj.per_stage_end == rt.per_stage_end
    with pytest.raises(ValueError):
        interop.micro_ops_from_arrays(
            **{**{f: getattr(jo, f) for f in ARRAYS},
               "deps": jo.deps[:, :2]}, n_resources=jo.n_resources)


def test_constants_and_profiles_equal():
    for name in ("PAPER_RAMDISK", "PAPER_HDD", "TPU_POD_STAGING"):
        assert dataclasses.asdict(getattr(J, name)) == \
            dataclasses.asdict(getattr(T, name)), name
    assert (J.DEAD_TIME, J.FAILED_THRESHOLD) == (T.DEAD_TIME,
                                                 T.FAILED_THRESHOLD)
    from repro.core.sweep import compiler_digest as j_digest
    from repro_torch.core.sweep import compiler_digest as t_digest
    assert j_digest() != t_digest()     # the two never share .npz entries


def test_grid_parity():
    kw = dict(n_nodes=[7, 9], chunk_sizes=[512 * 1024, J.MB],
              stripe_widths=(0, 2), replications=(1, 2))
    jg = J.grid(**kw, faults=(None, J.parse_faults(FAULT_SPEC)))
    tg = T.grid(**kw, faults=(None, T.parse_faults(FAULT_SPEC)))
    assert len(jg) == len(tg) > 0
    for a, b in zip(jg, tg):
        assert a.to_config().fingerprint() == b.to_config().fingerprint()


# ---------------- the port stands alone --------------------------------------------

def test_import_leaves_jax_and_repro_out():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core\n"
            "import repro_torch.kernels.sweep_scan.ops\n"
            "import repro_torch.models, repro_torch.configs\n"
            "import repro_torch.models.interop, repro_torch.train.step\n"
            "import repro_torch.kernels.flash_attention.ops\n"
            "import repro_torch.kernels.ssd.ops\n"
            "import repro_torch.kernels.moe_gmm.ops\n"
            "import repro_torch.core.trace, repro_torch.core.sysid\n"
            "import repro_torch.obs, repro_torch.serve\n"
            "import repro_torch.checkpoint, repro_torch.checkpoint.store\n"
            "import repro_torch.optim, repro_torch.data, repro_torch.train\n"
            "import repro_torch.launch.train, repro_torch.launch.elastic\n"
            "import repro_torch.kernels.counts, repro_torch.tree\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_sources_import_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        hits = pat.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_all_slice_modules_exist():
    pkg = Path(repro_torch.__file__).parent
    for rel in ("env.py", "core/faults.py", "core/types.py",
                "core/placement.py", "core/compile.py", "core/ref_sim.py",
                "core/workloads.py", "core/interop.py", "core/torch_sim.py",
                "core/predictor.py", "core/sweep/buckets.py",
                "core/sweep/compilecache.py", "core/sweep/engine.py",
                "core/sweep/backends.py", "core/sweep/session.py",
                "core/sweep/search.py", "obs/trace.py", "kernels/build.py",
                "kernels/sweep_scan/ref.py", "kernels/sweep_scan/kernel.py",
                "kernels/sweep_scan/ops.py",
                "kernels/sweep_scan/csrc/sweep_scan.cu",
                "models/config.py", "models/layers.py",
                "models/transformer.py", "models/ssm.py", "models/model.py",
                "models/interop.py", "models/__init__.py",
                "configs/__init__.py", "configs/zamba2_2p7b.py",
                "configs/granite_3_2b.py", "configs/mamba2_1p3b.py",
                "train/step.py", "kernels/flash_attention/ref.py",
                "kernels/flash_attention/kernel.py",
                "kernels/flash_attention/ops.py",
                "kernels/flash_attention/csrc/flash_attention.cu",
                "kernels/ssd/ref.py", "kernels/ssd/kernel.py",
                "kernels/ssd/ops.py", "kernels/ssd/csrc/ssd.cu",
                "core/trace/__init__.py", "core/trace/ir.py",
                "core/trace/wfcommons.py", "core/trace/dax.py",
                "core/trace/generate.py", "core/des.py", "core/emulator.py",
                "core/sysid.py", "obs/timeline.py", "obs/export.py",
                "serve/__init__.py", "serve/request.py",
                "serve/coalescer.py", "serve/results_cache.py",
                "serve/server.py", "checkpoint/planner.py",
                "checkpoint/store.py", "optim/adamw.py", "data/pipeline.py",
                "launch/train.py", "launch/elastic.py", "kernels/counts.py",
                "tree.py", "parallel/__init__.py", "parallel/sharding.py",
                "launch/mesh.py", "launch/analytic.py", "launch/dryrun.py",
                "launch/dryrun_meta.py"):
        assert (pkg / rel).is_file(), rel
