"""Pluggable execution backends: *how* a prepared sweep runs.

The reference has three execution paths — in-process
(`engine.SweepEngine`), device-sharded and multi-process. This module
names the seam they all share; the port has the in-process path so far:

* `SweepRun` — one sweep's worth of (workflow, config) pairs, simulatable
  any number of times (the scan pass, then exact-verification rounds).
  `_InlineRun` is the in-process one.
* `ExecutionBackend` — a policy object that turns (session, pairs) into
  a `SweepRun`. Both are `typing.Protocol`s: structural, no inheritance
  required, so external launchers can plug in without importing
  anything but the session.

Backends are stateless policy; every piece of *state* they touch —
engine, compile cache, mesh, worker pools — belongs to the
`session.SweepSession` handed to ``prepare``. `InlineBackend` is the
one built-in so far; the sharded and multi-process backends of the
reference arrive with their modules and must produce element-wise
identical makespans, so backend choice stays purely a throughput
decision.

`StLike` / `resolve_st` live here until the multi-process module, their
home in the reference, is ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, List, Optional, Protocol, Sequence,
                    runtime_checkable)

import numpy as np

from ...obs.trace import NULL_TRACER
from ..types import ServiceTimes, StorageConfig, Workflow

# a `ServiceTimes`, or a reference to one that ``resolve()``s to it (the
# persisted-sysid reference of the multi-process path)
StLike = Any


def resolve_st(st: StLike) -> ServiceTimes:
    """Materialize a service-times spec."""
    return st.resolve() if hasattr(st, "resolve") else st


@runtime_checkable
class SweepRun(Protocol):
    """A prepared sweep: simulate all pairs, or any index subset, in
    scan or exact mode — results in stable requested-index order."""

    def simulate(self, idxs: Optional[Sequence[int]] = None, *,
                 exact: bool = False) -> np.ndarray: ...


@runtime_checkable
class ExecutionBackend(Protocol):
    """Turns index-aligned (workflow, config) pairs into a `SweepRun`
    using the session's state. Implementations must be stateless across
    ``prepare`` calls — a backend can be shared by many sessions."""

    def prepare(self, session, wfs: Sequence[Workflow],
                cfgs: Sequence[StorageConfig], *, st: StLike,
                locality_aware: bool = True,
                compile_workers: Optional[int] = None) -> SweepRun: ...


@dataclass(frozen=True)
class _Spec:
    """One (workflow, config) pair, quacking like a `search.Candidate`
    for `CompileCache.compile_grid` (``to_config``), so prepared runs
    ride the same structural-dedup path and grid counters."""

    wf: Workflow
    cfg: StorageConfig

    def to_config(self) -> StorageConfig:
        return self.cfg


class _InlineRun:
    """In-process `SweepRun`: DAGs through the session's compile cache,
    simulation through the session's engine."""

    def __init__(self, engine, cache, wfs: Sequence[Workflow],
                 cfgs: Sequence[StorageConfig], *, st: StLike,
                 locality_aware: bool, compile_workers: Optional[int] = None,
                 tracer=None):
        assert len(wfs) == len(cfgs)
        self._engine = engine
        self._cache = cache
        self._specs = [_Spec(w, c) for w, c in zip(wfs, cfgs)]
        self._st = resolve_st(st)
        self._locality_aware = locality_aware
        self._compile_workers = compile_workers
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._ops: Optional[List] = None

    def _ops_list(self) -> List:
        # compiled once per run (structural classes dedup inside
        # compile_grid); every simulate call — scan, then each
        # verification round — reuses the same MicroOps references
        if self._ops is None:
            with self._tracer.span("compile_grid", phase="compile",
                                   candidates=len(self._specs)):
                self._ops = self._cache.compile_grid(
                    lambda s: s.wf, self._specs,
                    locality_aware=self._locality_aware,
                    workers=self._compile_workers)
        return self._ops

    def simulate(self, idxs: Optional[Sequence[int]] = None, *,
                 exact: bool = False) -> np.ndarray:
        ops = self._ops_list()
        if idxs is None:
            idxs = range(len(ops))
        idxs = list(idxs)
        return self._engine.simulate_batch(
            [ops[i] for i in idxs], [self._st] * len(idxs), exact=exact)


class InlineBackend:
    """Single-host, in-process execution on the session's engine and
    its device."""

    def prepare(self, session, wfs, cfgs, *, st, locality_aware=True,
                compile_workers=None) -> SweepRun:
        return _InlineRun(session.engine, session.compile_cache, wfs, cfgs,
                          st=st, locality_aware=locality_aware,
                          compile_workers=compile_workers,
                          tracer=session.tracer)
