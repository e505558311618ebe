"""`BENCHMARK.json` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Everything else is found from those names:

    bench/configs/<config>.json    the deployment (the entry's ``file``)
    bench/mixes/<traffic>.json     the traffic mix; its ``driver`` names
    bench/drivers/<driver>.py      the code that drives one entry point
    bench/limits/<workload>.json   the limits of the correctness checks
    bench/metrics/<metric>.py      one reader per per-layer metric

so a cell, a mix or a metric is added by adding files and entries.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(ValueError):
    """`BENCHMARK.json` or a file it names is missing or malformed."""


def load_json(path: Path) -> dict:
    try:
        return json.loads(Path(path).read_text())
    except FileNotFoundError:
        raise SpecError(f"missing file {path}") from None


def load_module(path: Path, name: str) -> ModuleType:
    """Import one file by path (metric and driver file names hold dots)."""
    if not Path(path).is_file():
        raise SpecError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of the benchmark with everything it names."""

    root: Path
    workload: dict
    config: dict          # the configuration's entry in BENCHMARK.json
    config_data: dict     # its file
    mix: dict             # bench/mixes/<traffic>.json
    limits: dict          # bench/limits/<workload>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]

    def driver_module(self) -> ModuleType:
        name = self.mix["driver"]
        if not NAME_RE.match(name):
            raise SpecError(f"bad driver name {name!r}")
        return load_module(self.root / "bench" / "drivers" / f"{name}.py",
                           f"bench_driver_{name}")

    def reader(self, metric: str) -> ModuleType:
        """The metric's reader, ``bench/metrics/<metric>.py``: its
        ``read(info)`` returns the value, or None where it finds nothing
        to read."""
        if not NAME_RE.match(metric):
            raise SpecError(f"bad metric name {metric!r}")
        return load_module(self.root / "bench" / "metrics" / f"{metric}.py",
                           "bench_metric_" + re.sub(r"\W", "_", metric))


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in bench["configs"]}.get(wl["config"])
    if cfg is None:
        raise SpecError(f"workload {workload!r} names no known config")
    for n in (wl["name"], wl["config"], wl["traffic"]):
        if not NAME_RE.match(n):
            raise SpecError(f"bad name {n!r}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload) and m["moves"] in reported]
    return Cell(root=root, workload=wl, config=cfg,
                config_data=load_json(root / cfg["file"]),
                mix=load_json(root / "bench" / "mixes" / f"{wl['traffic']}.json"),
                limits=load_json(root / "bench" / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer)
