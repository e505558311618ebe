"""State carried across from the reference package: constructors that turn
plain dicts and NumPy arrays into the port's `Workflow`,
`StorageConfig`, `ServiceTimes` and `MicroOps`.

The counterpart of a weight converter: the port never imports the
reference, so whoever holds reference-side objects (the parity tests,
a migration script) flattens them with `dataclasses.asdict` on *their*
side and hands the result over here. Both packages then simulate the
same DAG — including workflows ingested from trace files, whose parsers
are not ported yet.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np

from .compile import MAXD, MicroOps
from .faults import (DiskDegradation, FaultScenario, NodeFailure, Straggler)
from .types import (FileAttr, Placement, ServiceTimes, StorageConfig, Task,
                    Workflow)


def _placement(p: Any) -> Optional[Placement]:
    if p is None:
        return None
    return Placement(str(getattr(p, "value", p)))


def file_attr_from_dict(d: Optional[Mapping[str, Any]]) -> Optional[FileAttr]:
    if d is None:
        return None
    return FileAttr(placement=_placement(d.get("placement")),
                    replication=d.get("replication"),
                    collocate_group=d.get("collocate_group"))


def fault_scenario_from_dict(d: Optional[Mapping[str, Any]]
                             ) -> Optional[FaultScenario]:
    if d is None:
        return None
    return FaultScenario(
        failures=tuple(NodeFailure(**f) for f in d.get("failures", ())),
        degraded=tuple(DiskDegradation(**f) for f in d.get("degraded", ())),
        stragglers=tuple(Straggler(**f) for f in d.get("stragglers", ())),
        name=d.get("name", ""))


def task_from_dict(d: Mapping[str, Any]) -> Task:
    return Task(
        tid=int(d["tid"]),
        inputs=tuple(d["inputs"]),
        outputs=tuple((str(n), int(sz)) for n, sz in d["outputs"]),
        runtime=float(d.get("runtime", 0.0)),
        client=d.get("client"),
        stage=d.get("stage", ""),
        file_attrs={k: file_attr_from_dict(v)
                    for k, v in d.get("file_attrs", {}).items()})


def workflow_from_dict(d: Mapping[str, Any]) -> Workflow:
    """`Workflow` from ``dataclasses.asdict(workflow)`` of either
    package."""
    return Workflow(
        tasks=[task_from_dict(t) for t in d["tasks"]],
        name=d.get("name", "workflow"),
        preloaded={k: (int(sz), file_attr_from_dict(attr))
                   for k, (sz, attr) in d.get("preloaded", {}).items()})


def storage_config_from_dict(d: Mapping[str, Any]) -> StorageConfig:
    """`StorageConfig` from ``dataclasses.asdict(config)`` of either
    package (fault scenario included)."""
    return StorageConfig(
        n_hosts=int(d["n_hosts"]),
        storage_hosts=tuple(d["storage_hosts"]),
        client_hosts=tuple(d["client_hosts"]),
        manager_host=int(d.get("manager_host", 0)),
        stripe_width=int(d.get("stripe_width", 0)),
        replication=int(d.get("replication", 1)),
        chunk_size=int(d["chunk_size"]),
        placement=_placement(d.get("placement", Placement.ROUND_ROBIN)),
        faults=fault_scenario_from_dict(d.get("faults")))


def service_times_from_dict(d: Mapping[str, Any]) -> ServiceTimes:
    return ServiceTimes(**{k: float(v) for k, v in d.items()})


def micro_ops_from_arrays(*, res, cls, nbytes, reqs, extra, nlat, deps,
                          n_resources: int, res_mult=None, dead=None,
                          task_end_op: Optional[Mapping[int, int]] = None,
                          stage_of_task: Optional[Mapping[int, str]] = None,
                          file_write_op: Optional[Mapping[str, int]] = None,
                          bytes_moved: int = 0, storage_used: int = 0
                          ) -> MicroOps:
    """`MicroOps` from raw arrays (any array-likes; copied into the
    compiler's dtypes) — a compiled DAG handed over without recompiling."""
    res = np.array(res, dtype=np.int32)
    n = res.shape[0]
    deps = np.array(deps, dtype=np.int32).reshape(n, -1)
    if deps.shape[1] != MAXD:
        raise ValueError(f"deps must have {MAXD} slots per op, "
                         f"got {deps.shape[1]}")

    def f64(a, length):
        out = np.array(a, dtype=np.float64)
        if out.shape != (length,):
            raise ValueError(f"expected shape ({length},), got {out.shape}")
        return out

    return MicroOps(
        res=res, cls=np.array(cls, dtype=np.int8),
        nbytes=f64(nbytes, n), reqs=f64(reqs, n), extra=f64(extra, n),
        nlat=f64(nlat, n), deps=deps, n_resources=int(n_resources),
        task_end_op={int(k): int(v) for k, v in (task_end_op or {}).items()},
        stage_of_task={int(k): str(v)
                       for k, v in (stage_of_task or {}).items()},
        file_write_op={str(k): int(v)
                       for k, v in (file_write_op or {}).items()},
        bytes_moved=int(bytes_moved), storage_used=int(storage_used),
        res_mult=None if res_mult is None else f64(res_mult, int(n_resources)),
        dead=None if dead is None else f64(dead, n))
