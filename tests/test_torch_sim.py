"""The port's simulator (`repro_torch.core.torch_sim`, ``device="cpu"``)
against the reference's (`repro.core.jax_sim`).

Scan mode: makespan and every per-op completion time `np.array_equal`
(tolerance none — each arithmetic step of the port is one eager f64 op
in the reference's order, and XLA on the CPU does not contract the
reference's mul+add). Exact mode: within ``rtol=1e-12`` of the DES
oracle `ref_sim`, the bound the reference itself is held to.
"""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import jax_sim, workloads as JW
from repro.core.trace import load_trace, to_workflow
from repro.core.x64 import enable_x64

import repro_torch.core as T
from repro_torch.core import interop, ref_sim as t_ref, torch_sim
from repro_torch.core import workloads as TW

# the CPU paths step through tiny tensors one op at a time, where
# PyTorch's intra-op thread pool costs more than it gives and fights
# the other test workers for cores
torch.set_num_threads(1)

TRACES = Path(__file__).resolve().parents[1] / "examples" / "traces"
FIXTURES = ["montage_small.json", "blast_small.json", "cycles_small.dax"]
FAULT_SPEC = "disk=0:8,kill=1@40"
KILL_EARLY = "disk=1:4,kill=0@3,slow=0:4"


def compiled_pair(name, spec=None, replication=1, chunk=T.MB):
    """The same DAG compiled by both packages: (reference MicroOps,
    port MicroOps)."""
    if name in FIXTURES:
        jwf = to_workflow(load_trace(TRACES / name))
        twf = interop.workflow_from_dict(dataclasses.asdict(jwf))
    elif name == "blast":
        jwf = JW.blast(4, n_queries=12, db_mb=32)
        twf = TW.blast(4, n_queries=12, db_mb=32)
    else:
        jwf = JW.map_reduce_shuffle(4, 3, in_mb=8, part_mb=1, out_mb=4)
        twf = TW.map_reduce_shuffle(4, 3, in_mb=8, part_mb=1, out_mb=4)
    jcfg = J.partitioned_config(4, 3, chunk_size=chunk,
                                replication=replication,
                                faults=J.parse_faults(spec) if spec else None)
    tcfg = interop.storage_config_from_dict(dataclasses.asdict(jcfg))
    return J.compile_workflow(jwf, jcfg), T.compile_workflow(twf, tcfg)


def jax_scan_end(jo, st):
    """Per-op completion times of the reference's scan mode, in
    original op order."""
    perm = jax_sim.scan_order(jo, st)
    a = jax_sim.OpArrays.from_micro_ops(jo, perm=perm)
    fa = (jax_sim.FaultArrays.from_micro_ops(jo, perm=perm)
          if jax_sim.faulted(jo) else None)
    with enable_x64():
        mk, end = jax_sim.simulate_arrays(
            a, jnp.asarray(jax_sim.st_to_vec(st)),
            n_resources=jo.n_resources, exact=False, f=fa)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return float(mk), np.asarray(end)[inv]


def torch_scan_end(to, st):
    perm = torch_sim.scan_order(to, st)
    a = torch_sim.OpArrays.from_micro_ops(to, perm=perm, device="cpu").batched()
    fa = (torch_sim.FaultArrays.from_micro_ops(to, perm=perm,
                                               device="cpu").batched()
          if torch_sim.faulted(to) else None)
    mk, end = torch_sim.simulate_arrays(
        a, torch.from_numpy(torch_sim.st_to_vec(st)[None]),
        n_resources=to.n_resources, exact=False, f=fa)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return float(mk[0]), end[0].numpy()[inv]


CASES = [(name, spec, rep)
         for name in FIXTURES + ["blast", "map_reduce_shuffle"]
         for spec, rep in ((None, 1), (FAULT_SPEC, 1), (FAULT_SPEC, 2))]


@pytest.mark.parametrize("name,spec,replication", CASES)
def test_scan_mode_equal_to_reference(name, spec, replication):
    jo, to = compiled_pair(name, spec, replication)
    mk_j, end_j = jax_scan_end(jo, J.PAPER_RAMDISK)
    mk_t, end_t = torch_scan_end(to, T.PAPER_RAMDISK)
    assert mk_j == mk_t
    np.testing.assert_array_equal(end_j, end_t)
    # and through the public single-run entry point
    rj = jax_sim.simulate(jo, J.PAPER_RAMDISK)
    rt = torch_sim.simulate(to, T.PAPER_RAMDISK, device="cpu")
    assert rj.makespan == rt.makespan == mk_t
    assert rj.per_task_end == rt.per_task_end
    assert rj.per_stage_end == rt.per_stage_end
    assert rj.failed == rt.failed


def test_scan_mode_equal_with_dead_ops():
    """A scenario that really kills reads: the run fails in both
    packages with the same DEAD_TIME-laden makespan."""
    jo, to = compiled_pair("montage_small.json", KILL_EARLY, 1)
    assert to.dead is not None and to.dead.sum() > 0
    rj = jax_sim.simulate(jo, J.PAPER_HDD)
    rt = torch_sim.simulate(to, T.PAPER_HDD, device="cpu")
    assert rt.failed and rj.failed
    assert rj.makespan == rt.makespan >= T.FAILED_THRESHOLD
    assert rj.per_task_end == rt.per_task_end


@pytest.mark.parametrize("name,spec,replication", [
    ("blast", None, 1), ("blast", FAULT_SPEC, 2),
    ("map_reduce_shuffle", KILL_EARLY, 1),
    ("blast_small.json", FAULT_SPEC, 2)])
def test_exact_mode_within_rtol_of_oracle(name, spec, replication):
    jo, to = compiled_pair(name, spec, replication)
    ref = t_ref.simulate(to, T.PAPER_RAMDISK)
    rt = torch_sim.simulate(to, T.PAPER_RAMDISK, exact=True, device="cpu")
    np.testing.assert_allclose(rt.makespan, ref.makespan, rtol=1e-12)
    assert rt.per_task_end.keys() == ref.per_task_end.keys()
    for tid, t in ref.per_task_end.items():
        np.testing.assert_allclose(rt.per_task_end[tid], t, rtol=1e-12)
    rj = jax_sim.simulate(jo, J.PAPER_RAMDISK, exact=True)
    np.testing.assert_allclose(rt.makespan, rj.makespan, rtol=1e-12)


def test_argmin_takes_the_first_of_equal_keys():
    """The tie rule exact mode rests on (checked on the card too, by
    `chip_smoke.py`)."""
    key = torch.full((4, 1000), 3.0, dtype=torch.float64)
    key[:, 500:] = 2.0
    assert key.argmin(dim=1).tolist() == [500] * 4
    assert int(torch.zeros(4097, dtype=torch.float64).argmin()) == 0


@pytest.mark.parametrize("exact", [False, True])
def test_simulate_batch_equal_to_reference(exact):
    """A mixed batch — different op counts and resource counts, healthy
    and faulted rows together — through both `simulate_batch`es."""
    specs = [("blast", None, 1, T.MB), ("blast", FAULT_SPEC, 2, T.MB),
             ("map_reduce_shuffle", None, 1, 512 * 1024),
             ("map_reduce_shuffle", KILL_EARLY, 1, T.MB)]
    pairs = [compiled_pair(*s) for s in specs]
    sts_j = [J.PAPER_RAMDISK, J.PAPER_HDD, J.PAPER_RAMDISK, J.PAPER_HDD]
    sts_t = [T.PAPER_RAMDISK, T.PAPER_HDD, T.PAPER_RAMDISK, T.PAPER_HDD]
    vj = jax_sim.simulate_batch([p[0] for p in pairs], sts_j, exact=exact)
    vt = torch_sim.simulate_batch([p[1] for p in pairs], sts_t, exact=exact,
                                  device="cpu")
    assert vt.dtype == np.float64
    if exact:
        np.testing.assert_allclose(vt, vj, rtol=1e-12)
        ref = [t_ref.simulate(p[1], s).makespan for p, s in zip(pairs, sts_t)]
        np.testing.assert_allclose(vt, ref, rtol=1e-12)
    else:
        np.testing.assert_array_equal(vt, vj)


def test_sweep_service_times_and_what_if_equal():
    jo, to = compiled_pair("blast", FAULT_SPEC, 2)
    profiles_j = [J.PAPER_RAMDISK, J.PAPER_HDD, J.TPU_POD_STAGING,
                  J.PAPER_RAMDISK.replace(storage=1.0 / (500 * J.MB))]
    profiles_t = [interop.service_times_from_dict(dataclasses.asdict(p))
                  for p in profiles_j]
    vecs = np.stack([jax_sim.st_to_vec(p) for p in profiles_j])
    np.testing.assert_array_equal(
        vecs, np.stack([torch_sim.st_to_vec(p) for p in profiles_t]))
    vj = jax_sim.sweep_service_times(jo, vecs, st_ref=J.PAPER_HDD)
    vt = torch_sim.sweep_service_times(to, vecs, st_ref=T.PAPER_HDD,
                                       device="cpu")
    np.testing.assert_array_equal(vj, vt)
    ej = jax_sim.sweep_service_times(jo, vecs[:2], exact=True)
    et = torch_sim.sweep_service_times(to, vecs[:2], exact=True, device="cpu")
    np.testing.assert_allclose(et, ej, rtol=1e-12)

    jwf, twf = JW.blast(4, n_queries=12, db_mb=32), TW.blast(4, n_queries=12,
                                                             db_mb=32)
    jcfg = J.partitioned_config(4, 3, chunk_size=J.MB)
    tcfg = T.partitioned_config(4, 3, chunk_size=T.MB)
    wj = J.Predictor(J.PAPER_RAMDISK, session=J.SweepSession()).what_if(
        jwf, jcfg, profiles_j)
    wt = T.Predictor(T.PAPER_RAMDISK, device="cpu").what_if(twf, tcfg,
                                                            profiles_t)
    np.testing.assert_array_equal(wj, wt)


def test_refine_pass_equal_to_reference(monkeypatch):
    """`SCAN_REFINE_PASSES` means the same in both packages: with a
    second pass switched on, the un-jitted reference body and the port
    still agree element-wise (stable re-sort, renumbered deps)."""
    monkeypatch.setattr(jax_sim, "SCAN_REFINE_PASSES", 2)
    monkeypatch.setattr(torch_sim, "SCAN_REFINE_PASSES", 2)
    jo, to = compiled_pair("map_reduce_shuffle", FAULT_SPEC, 2)
    perm = jax_sim.scan_order(jo, J.PAPER_RAMDISK)
    with enable_x64():
        a = jax_sim.OpArrays.from_micro_ops(jo, perm=perm)
        fa = jax_sim.FaultArrays.from_micro_ops(jo, perm=perm)
        mk_j, end_j = jax_sim._sim_scan(
            a, jnp.asarray(jax_sim.st_to_vec(J.PAPER_RAMDISK)),
            jo.n_resources, fa)
        mk_j, end_j = float(mk_j), np.asarray(end_j)
    ta = torch_sim.OpArrays.from_micro_ops(to, perm=perm, device="cpu").batched()
    tf = torch_sim.FaultArrays.from_micro_ops(to, perm=perm,
                                              device="cpu").batched()
    mk_t, end_t = torch_sim._sim_scan(
        ta, torch.from_numpy(torch_sim.st_to_vec(T.PAPER_RAMDISK)[None]),
        to.n_resources, tf)
    assert mk_j == float(mk_t[0])
    np.testing.assert_array_equal(end_j, end_t[0].numpy())
    # the second pass really changed something
    monkeypatch.setattr(torch_sim, "SCAN_REFINE_PASSES", 1)
    _, end_1 = torch_sim._sim_scan(
        ta, torch.from_numpy(torch_sim.st_to_vec(T.PAPER_RAMDISK)[None]),
        to.n_resources, tf)
    assert not np.array_equal(end_1[0].numpy(), end_t[0].numpy())


def test_every_sweep_path_tensor_is_f64_or_index():
    _, to = compiled_pair("blast", FAULT_SPEC, 2)
    a = torch_sim.OpArrays.from_micro_ops(to, pad_to=4096, device="cpu")
    f = torch_sim.FaultArrays.from_micro_ops(to, pad_to=4096, n_resources=64,
                                             device="cpu")
    n = torch_sim.FaultArrays.neutral(4096, 64, device="cpu")
    assert a.res.dtype == a.deps.dtype == torch.int32
    assert a.cls.dtype == torch.int64
    for t in (a.nbytes, a.reqs, a.extra, a.nlat, f.res_mult, f.dead,
              n.res_mult, n.dead):
        assert t.dtype == torch.float64
    assert a.res.shape == (4096,) and a.deps.shape == (4096, 4)
    assert bool((a.deps[to.n_ops:] == -1).all())
    assert f.res_mult.shape == (64,) and bool((n.res_mult == 1).all())


def test_timeline_is_not_ported_yet():
    _, to = compiled_pair("blast")
    with pytest.raises(NotImplementedError):
        torch_sim.simulate(to, T.PAPER_RAMDISK, timeline=True, device="cpu")
