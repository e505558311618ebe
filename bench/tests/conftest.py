"""Shared pieces of the benchmark's own tests (run them with
``python -m pytest -q bench/tests``; the repository's tier-1 run collects
``tests/`` only).

`tiny_checkout` builds a checkout in a temporary directory whose
`BENCHMARK.json` holds two small cells added as data alone (a
configuration, a mix and limits for each, reusing the drivers and
readers), small enough to run on the CPU.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (decided inside the test)")


TINY_BLAST = {
    "name": "tiny-blast", "source": "a small BLAST for the CPU tests",
    "cluster": {"layout": "partitioned", "n_nodes": 6, "manager_nodes": 1},
    "workflow": {"pattern": "blast",
                 "args": {"db_mb": 24, "per_query_s": 4.0, "query_mb": 1,
                          "out_mb": 2}},
    "storage": {"replication": 1, "placement": "round_robin"},
    "locality_aware": True,
    "reduced": ["db_mb", "n_nodes"],
}
TINY_FIG3 = {
    "name": "tiny-fig3", "source": "small synthetic patterns for the CPU tests",
    "cluster": {"layout": "collocated", "n_hosts": 5},
    "storage": {"stripe_width": 0, "replication": 1, "placement": "round_robin"},
    "chunk_sizes": [4194304, 8388608],
    "patterns": [
        {"name": "pipeline-wass", "pattern": "pipeline",
         "args": {"n_pipes": 3, "wass": True, "stage_mb": [8, 16, 8, 2]},
         "locality_aware": True},
        {"name": "reduce-dss", "pattern": "reduce_",
         "args": {"n_workers": 3, "in_mb": 8, "mid_mb": 8, "out_mb": 16},
         "locality_aware": False},
        {"name": "broadcast-r2", "pattern": "broadcast",
         "args": {"n_consumers": 3, "replication": 2, "file_mb": 8},
         "locality_aware": True},
    ],
    "reduced": ["n_hosts"],
}
TINY_NEWJOBS = {
    "driver": "advisor_submit", "loop": "closed", "clients": 2,
    "request": {"n_queries": {"permutation": [5, 60]},
                "n_app": {"repeat": [3, 1, 4, 2]}},
    "candidates": {"chunk_sizes": [4194304, 8388608], "stripe_widths": [0, 2]},
    "verify_top_k": 0, "objective": "makespan",
    "warmup": [{"n_queries": 3, "n_app": 1}],
    "check": {"answers": 3, "longest_by": "n_app"},
}
TINY_WHATIF = {
    "driver": "what_if", "loop": "closed", "clients": 1,
    "request": {"deployment": {"cycle": [2, 1, 1, 1, 1, 1]}},
    "profiles": {"count": 6, "ranges": {
        "net_remote": {"log_uniform": [7.45e-11, 8.0e-09]},
        "net_local": {"fixed": 4.233284430070357e-10},
        "net_latency": {"uniform": [1e-05, 0.0002]},
        "storage": {"log_uniform": [8.4e-11, 1.0e-08]},
        "manager": {"log_uniform": [0.0002, 0.0008]},
        "client": {"fixed": 0.0},
        "storage_req": {"log_uniform": [0.00015, 0.0006]}}},
    "check": {"answers": 3, "profiles_per_answer": 6},
}


def _limits(root: Path, name: str) -> dict:
    return json.loads((root / "bench" / "limits" / f"{name}.json").read_text())


def make_checkout(dst: Path) -> Path:
    """A checkout in ``dst`` with the benchmark's files, the program
    linked in, and the two tiny cells added as data."""
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", dst / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    st = json.loads((ROOT / "bench" / "configs" / "blast-s1.json")
                    .read_text())["service_times"]
    for cfg, mix, lim_of, traffic in (
            (TINY_BLAST, TINY_NEWJOBS, "blast-s1.newjobs", "tiny-newjobs"),
            (TINY_FIG3, TINY_WHATIF, "fig3-synthetic.whatif", "tiny-whatif")):
        (dst / "bench" / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(dict(cfg, service_times=st)))
        (dst / "bench" / "mixes" / f"{traffic}.json").write_text(json.dumps(mix))
        wl = f"{cfg['name']}.{traffic}"
        (dst / "bench" / "limits" / f"{wl}.json").write_text(
            json.dumps(_limits(ROOT, lim_of)))
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                 "file": f"bench/configs/{cfg['name']}.json",
                                 "reduced": cfg["reduced"], "why": "CPU tests"})
        bench["workloads"].append({"name": wl, "config": cfg["name"],
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        for old, new in (("blast-s1.newjobs", "tiny-blast.tiny-newjobs"),
                         ("fig3-synthetic.whatif", "tiny-fig3.tiny-whatif")):
            if old in m.get("workloads", ()):
                m["workloads"].append(new)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_checkout(tmp_path_factory.mktemp("checkout"))


NEWJOBS = "tiny-blast.tiny-newjobs"
WHATIF = "tiny-fig3.tiny-whatif"
