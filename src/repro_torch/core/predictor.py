"""Public predictor facade — the paper's contribution as one composable
object: give it a workload description, a storage configuration, and a
seed (measured or hypothetical), get a turnaround-time prediction.

Backends:
    "ref"   — exact Python DES oracle (paper-faithful queue model)
    "exact" — same semantics as PyTorch tensor ops, equal to ref
    "scan"  — fast mode for batched sweeps (±10% vs oracle): the CUDA
              sweep-scan kernel on a CUDA device

Batched prediction runs through a `sweep.SweepSession`: pass one via
``session=`` (sharing it across predictors shares DAGs, device batches
and worker pools), or let the predictor derive its own from the legacy
``compile_cache=``/``devices=``/``workers=`` knobs. Derived sessions
with any of those set are *private*: two predictors with different
``devices=`` keep independent meshes instead of re-pointing a shared
engine. ``device`` (default ``"cuda"``, raising when no card is present)
is where single runs execute and where a derived session's engine
lives; an explicit ``session=`` keeps its own device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..env import DeviceLike, resolve_device
from . import ref_sim, torch_sim
from .compile import MicroOps
from .sweep.backends import InlineBackend, ShardedBackend
from .sweep.compilecache import CompileCache
from .sweep.multiproc import MultiprocBackend
from .sweep.session import SweepSession, default_session
from .types import RunReport, ServiceTimes, StorageConfig, Workflow


@dataclass
class Predictor:
    service_times: ServiceTimes
    locality_aware: bool = True
    # None => the session's structure-keyed DAG cache; pass
    # CompileCache(enabled=False) to force fresh compiles
    compile_cache: Optional[CompileCache] = None
    # candidate-batch sharding for predict_batch (`sweep.shard.resolve_mesh`
    # semantics: 0 = all visible devices, n = first n). Applies to this
    # predictor's private session only — other predictors and the
    # default session keep their own placement.
    devices: Optional[object] = None
    # host-process fan-out for predict_batch (`sweep.multiproc`): > 1
    # partitions the batch's structural-class groups across worker
    # processes
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
            dev = resolve_device(self.device)
            if (self.compile_cache is None and self.devices is None
                    and self.workers is None and dev.type == "cuda"):
                sess = default_session()
            else:
                n_workers = max(int(self.workers or 1), 1)
                if n_workers > 1:
                    backend = MultiprocBackend(n_workers, shared_pools=True)
                elif self.devices is not None:
                    backend = ShardedBackend(self.devices)
                else:
                    backend = InlineBackend()
                # private engine on the predictor's device => private
                # mesh: devices= must not clobber anyone else's
                # placement. The DAG cache is placement-independent, so
                # a CUDA predictor shares the default one for warmth
                # unless the caller supplied their own.
                cache = self.compile_cache
                if cache is None and dev.type == "cuda":
                    cache = default_session().compile_cache
                sess = SweepSession(backend, compile_cache=cache, device=dev)
            self._derived = sess
        return sess

    def _device(self):
        """Single runs follow the session's engine when one was given."""
        return self.session.device if self.session is not None \
            else resolve_device(self.device)

    def sweep_session(self) -> SweepSession:
        """The session this predictor executes on (derived on first use
        when ``session=`` was not given). The public seam for layers
        that build *on top of* a predictor —
        `serve.AdvisorServer.from_predictor` shares its warm engine, DAG
        cache and worker pools through this."""
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
        predictor's session (bucketed + cached; sharded or fanned out
        across host processes per the session's backend — results
        identical either way)."""
        return self._session().simulate_batch(
            list(wfs), list(cfgs), st=self.service_times,
            locality_aware=self.locality_aware)

    def what_if(self, wf: Workflow, cfg: StorageConfig,
                profiles: Sequence[ServiceTimes]) -> np.ndarray:
        """§2.1 what-if exploration: same deployment, hypothetical hardware
        (e.g. SSDs) — one DAG, many service-time vectors, one batched
        call. The session's tracer records the question as a ``what_if``
        span (its DAG lookup included) over ``what_if.*`` parts, and the
        session's `CacheStats` count the scan's kernel launches."""
        sess = self._session()
        tracer = sess.tracer
        t0 = tracer.clock()
        ops = self.compile(wf, cfg)
        with tracer.span("what_if.vectors", phase="host-prep"):
            vecs = np.stack([torch_sim.st_to_vec(p) for p in profiles])
        out = torch_sim.sweep_service_times(ops, vecs,
                                            st_ref=self.service_times,
                                            device=self._device(),
                                            tracer=tracer, stats=sess.stats)
        tracer.record("what_if", t0, tracer.clock(), phase="what-if",
                      ops=ops.n_ops, profiles=len(profiles))
        return out
