"""Public predictor facade — the paper's contribution as one composable
object: give it a workload description, a storage configuration, and a
seed (measured or hypothetical), get a turnaround-time prediction.

Backends:
    "ref"   — exact Python DES oracle (paper-faithful queue model)
    "exact" — same semantics as PyTorch tensor ops, equal to ref
    "scan"  — fast mode for batched sweeps (±10% vs oracle): the CUDA
              sweep-scan kernel on a CUDA device

Batched prediction runs through a `sweep.SweepSession`: pass one via
``session=`` (sharing it across predictors shares DAGs and device
batches), or let the predictor derive its own. ``device`` (default
``"cuda"``, raising when no card is present) is where single runs
execute and where a derived session's engine lives; an explicit
``session=`` keeps its own device. The reference's ``devices=`` /
``workers=`` knobs name backends the port does not have yet and raise
`NotImplementedError`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..env import DeviceLike, resolve_device
from . import ref_sim, torch_sim
from .compile import MicroOps
from .sweep.backends import InlineBackend
from .sweep.compilecache import CompileCache
from .sweep.session import SweepSession, default_session
from .types import RunReport, ServiceTimes, StorageConfig, Workflow


@dataclass
class Predictor:
    service_times: ServiceTimes
    locality_aware: bool = True
    # None => the session's structure-keyed DAG cache; pass
    # CompileCache(enabled=False) to force fresh compiles
    compile_cache: Optional[CompileCache] = None
    # sharded / multi-process execution: not ported yet (raise when set)
    devices: Optional[object] = None
    workers: Optional[int] = None
    # explicit execution state; overrides the knobs above
    session: Optional[SweepSession] = None
    # where single runs and a derived session execute
    device: DeviceLike = "cuda"

    def _session(self) -> SweepSession:
        if self.session is not None:
            return self.session
        sess = getattr(self, "_derived", None)
        if sess is None:
            if self.devices is not None or max(int(self.workers or 1), 1) > 1:
                raise NotImplementedError(
                    "devices= / workers= need the sharded and multi-process "
                    "backends, which are not ported yet")
            dev = resolve_device(self.device)
            if self.compile_cache is None and dev.type == "cuda":
                sess = default_session()
            else:
                # a private session on the predictor's device (and the
                # caller's DAG cache, when one was given)
                sess = SweepSession(InlineBackend(),
                                    compile_cache=self.compile_cache,
                                    device=dev)
            self._derived = sess
        return sess

    def _device(self):
        """Single runs follow the session's engine when one was given."""
        return self.session.device if self.session is not None \
            else resolve_device(self.device)

    def sweep_session(self) -> SweepSession:
        """The session this predictor executes on (derived on first use
        when ``session=`` was not given). The public seam for layers
        that build *on top of* a predictor and want to share its warm
        engine and DAG cache."""
        return self._session()

    def compile(self, wf: Workflow, cfg: StorageConfig) -> MicroOps:
        return self._session().compile_cache.get(
            wf, cfg, locality_aware=self.locality_aware)

    def predict(self, wf: Workflow, cfg: StorageConfig, *,
                backend: str = "ref") -> RunReport:
        if backend not in ("ref", "exact", "scan"):
            raise ValueError(f"unknown backend {backend!r}")
        ops = self.compile(wf, cfg)
        if backend == "ref":
            return ref_sim.simulate(ops, self.service_times)
        return torch_sim.simulate(ops, self.service_times,
                                  exact=backend == "exact",
                                  device=self._device())

    def predict_batch(self, wfs: Sequence[Workflow],
                      cfgs: Sequence[StorageConfig]) -> np.ndarray:
        """One batched sweep across configurations through the
        predictor's session (bucketed + cached)."""
        return self._session().simulate_batch(
            list(wfs), list(cfgs), st=self.service_times,
            locality_aware=self.locality_aware)

    def what_if(self, wf: Workflow, cfg: StorageConfig,
                profiles: Sequence[ServiceTimes]) -> np.ndarray:
        """§2.1 what-if exploration: same deployment, hypothetical hardware
        (e.g. SSDs) — one DAG, many service-time vectors, one batched
        call."""
        ops = self.compile(wf, cfg)
        vecs = np.stack([torch_sim.st_to_vec(p) for p in profiles])
        return torch_sim.sweep_service_times(ops, vecs,
                                             st_ref=self.service_times,
                                             device=self._device())
