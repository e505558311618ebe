"""The frozen plain reference agrees with the port's CPU path on small
DAGs of both configurations: the same DAG to the bit, the same serving
order, the same makespans."""
from __future__ import annotations

import dataclasses
import importlib
import json

import numpy as np
import pytest
from conftest import ROOT

from bench.reference import compiler as ref_compiler
from bench.reference import scan as ref_scan
from repro_torch.core import torch_sim, workloads
from repro_torch.core.compile import compile_workflow
from repro_torch.core.types import (KB, MB, PAPER_RAMDISK, Placement,
                                    ServiceTimes, collocated_config,
                                    partitioned_config)

FIG3 = json.loads((ROOT / "bench" / "configs" / "fig3-synthetic.json").read_text())
BLAST = json.loads((ROOT / "bench" / "configs" / "blast-s1.json").read_text())
ARRAYS = ("res", "cls", "nbytes", "reqs", "extra", "nlat", "deps")


def _same_dag(ref, ops):
    for k in ARRAYS:
        a, b = ref[k], getattr(ops, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert ref["n_resources"] == ops.n_resources


def _same_scan(ref, ops, profiles):
    dag = ref_scan.Dag(ref, BLAST["service_times"])
    assert dag.order == torch_sim.scan_order(ops, PAPER_RAMDISK).tolist()
    vecs = np.array([[p[k] for k in ref_scan.PROFILE_KEYS] for p in profiles])
    got = torch_sim.sweep_service_times(ops, vecs, st_ref=PAPER_RAMDISK,
                                        device="cpu")
    want = [dag.makespan(p) for p in profiles]
    assert got.tolist() == want
    # many profiles at once: the same makespans, to the bit
    assert dag.makespans(vecs).tolist() == want
    assert ref_scan.makespans(ref, dag.order, vecs, block=7).tolist() == want


def _profiles(n, seed):
    rng = np.random.default_rng(seed)
    base = dataclasses.asdict(PAPER_RAMDISK)
    return [dict(base, storage=float(s), net_remote=float(r),
                 net_latency=float(la))
            for s, r, la in zip(np.exp(rng.uniform(-23, -18, n)),
                                np.exp(rng.uniform(-23, -18, n)),
                                rng.uniform(1e-5, 2e-4, n))]


def test_service_times_are_the_ports_paper_ramdisk():
    for cfg in (BLAST, FIG3):
        assert ServiceTimes(**cfg["service_times"]) == PAPER_RAMDISK


@pytest.mark.parametrize("pat", FIG3["patterns"], ids=lambda p: p["name"])
def test_fig3_patterns(pat):
    n = 4
    args = dict(pat["args"])
    key = {"pipeline": "n_pipes", "reduce_": "n_workers",
           "broadcast": "n_consumers"}[pat["pattern"]]
    args[key] = n
    mb = {"pipeline": {"stage_mb": (12, 24, 12, 2)},
          "reduce_": {"in_mb": 12, "mid_mb": 12, "out_mb": 24},
          "broadcast": {"file_mb": 12}}[pat["pattern"]]
    args.update(mb)
    build = importlib.import_module(f"bench.reference.patterns.{pat['pattern']}").build
    for ck in (1 * MB, 4 * MB):
        ref = ref_compiler.compile_dag(build(**args),
                                       ref_compiler.collocated(n + 1, chunk_size=ck),
                                       locality_aware=pat["locality_aware"])
        ops = compile_workflow(getattr(workloads, pat["pattern"])(**args),
                               collocated_config(n + 1, chunk_size=ck),
                               locality_aware=pat["locality_aware"])
        _same_dag(ref, ops)
        _same_scan(ref, ops, _profiles(3, ck))


@pytest.mark.parametrize("n_app,n_storage,stripe", [(1, 3, 0), (3, 2, 0),
                                                    (2, 4, 2), (4, 1, 0)])
def test_blast_partitions(n_app, n_storage, stripe):
    args = dict(BLAST["workflow"]["args"], db_mb=20, out_mb=2)
    build = importlib.import_module("bench.reference.patterns.blast").build
    for ck in (512 * KB, 4 * MB):
        ref = ref_compiler.compile_dag(
            build(n_app, n_queries=37, **args),
            ref_compiler.partitioned(n_app, n_storage, chunk_size=ck,
                                     stripe_width=stripe),
            locality_aware=True)
        ops = compile_workflow(
            workloads.blast(n_app, n_queries=37, **args),
            partitioned_config(n_app, n_storage, chunk_size=ck,
                               stripe_width=stripe,
                               placement=Placement.ROUND_ROBIN),
            locality_aware=True)
        _same_dag(ref, ops)
        _same_scan(ref, ops, [BLAST["service_times"]] + _profiles(2, n_app))
