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
    assert jo.n_resources == to.n_resources
    for f in ARRAYS:
        a, b = getattr(jo, f), getattr(to, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert jo.task_end_op == to.task_end_op
    assert jo.stage_of_task == to.stage_of_task
    assert (jo.bytes_moved, jo.storage_used) == (to.bytes_moved,
                                                 to.storage_used)

    rj = j_ref.simulate(jo, J.PAPER_RAMDISK)
    rt = t_ref.simulate(to, T.PAPER_RAMDISK)
    assert rj.makespan == rt.makespan
    assert rj.per_task_end == rt.per_task_end
    assert rj.failed == rt.failed

    pj = jax_sim.scan_order(jo, J.PAPER_RAMDISK)
    pt = torch_sim.scan_order(to, T.PAPER_RAMDISK)
    assert pj.dtype == pt.dtype
    np.testing.assert_array_equal(pj, pt)


@pytest.mark.parametrize("name", WORKLOADS)
def test_scan_order_levels_equal_loop(name):
    """The level-wise NumPy forward pass and the op-by-op loop give the
    same estimated starts, to the bit (same max and + per op)."""
    _, twf = workflow_pair(name)
    _, tcfg = config_pair("faulted", 2)
    ops = T.compile_workflow(twf, tcfg)
    dur = t_ref.durations(ops, T.PAPER_HDD) + ops.nlat * T.PAPER_HDD.net_latency
    np.testing.assert_array_equal(torch_sim._scan_order_levels(ops, dur),
                                  torch_sim._scan_order_loop(ops, dur))


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
                "tree.py"):
        assert (pkg / rel).is_file(), rel
