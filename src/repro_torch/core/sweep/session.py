"""`SweepSession`: one isolated unit of sweep *state* with an explicit
lifecycle — the seam a prediction service or a multi-host launcher
plugs into.

A session gathers everything a sweep touches behind one object, instead
of process-wide singletons that callers would clobber for each other:

    engine         — `SweepEngine`: per-bucket callable LRU + host-prep
                     caches + device + mesh + `CacheStats` rollup
                     (worker and device counters included)
    compile_cache  — `CompileCache`: structure-keyed DAG LRU, optionally
                     disk-persisted (``cache_dir=``)
    backend        — `backends.ExecutionBackend`: HOW sweeps run
                     (inline / device-sharded / multi-process) — one
                     constructor argument instead of threaded kwargs
    sysid          — optional `sysid.SysIdReport` (or a path to a saved
                     one) whose service times are the session default
                     for `prepare`
    pools          — lazily-spawned `multiproc.PoolHandle`s, shut by
                     `close()`

Two sessions never interfere: each owns its engine (hence its device,
mesh and caches), so `Predictor(devices=...)` re-points no one else's
placement. ``close()`` (or the context manager) releases everything the
session pinned; the session stays constructed but refuses new pools.

`default_session()` is the one sanctioned process-wide accessor — it
backs the legacy `default_engine()` / `default_compile_cache()` shims
and keeps one-shot scripts as convenient as before. Like every entry
point of the port it runs on CUDA and raises when no card is present.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Union

from ...env import DeviceLike
from ...obs.trace import NULL_TRACER
from ..sysid import SysIdReport
from ..types import StorageConfig, Workflow
from .backends import (ExecutionBackend, InlineBackend, ShardedBackend,
                       SweepRun)
from .compilecache import CompileCache
from .engine import SIM_ENGINES, SweepEngine
from .multiproc import MultiprocBackend, PoolHandle, StLike


class SweepSession:
    """Owns sweep state; delegates execution to its backend.

    ``backend`` defaults to `backends.InlineBackend`. ``engine`` /
    ``compile_cache`` default to fresh private instances (pass the
    default session's to share warmth deliberately); ``cache_dir`` is a
    convenience for a disk-persisted `CompileCache`. ``sysid`` (a
    `SysIdReport`, a path to one saved by `SysIdReport.save`, or any
    object with a ``service_times`` attribute) supplies default service
    times for `prepare`. ``tracer`` (an `obs.trace.Tracer`) turns on
    wall-clock span recording across the pipeline — engine buckets,
    backend compile/dispatch, multiproc workers; the `NULL_TRACER`
    default records nothing and changes no behaviour. ``device`` is where a session-built engine
    runs (default ``"cuda"``, raising when no card is present); a
    borrowed ``engine=`` keeps its own device.
    """

    def __init__(self, backend: Optional[ExecutionBackend] = None, *,
                 engine: Optional[SweepEngine] = None,
                 compile_cache: Optional[CompileCache] = None,
                 cache_dir: Optional[str] = None,
                 sysid: Optional[Union[SysIdReport, str, Any]] = None,
                 sim_engine: Optional[str] = None,
                 tracer=None,
                 device: DeviceLike = "cuda"):
        self.backend: ExecutionBackend = \
            backend if backend is not None else InlineBackend()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if engine is not None:
            self.engine = engine
            if tracer is not None:
                # re-point a borrowed engine's recorder only on explicit
                # request — never silence (or hijack) a sharing session
                self.engine.tracer = tracer
            if sim_engine is not None:
                # re-point a borrowed engine's scan body; the callable
                # cache key carries the flag, so no stale entries serve
                if sim_engine not in SIM_ENGINES:
                    raise ValueError(f"sim_engine must be one of "
                                     f"{SIM_ENGINES}, got {sim_engine!r}")
                self.engine.sim_engine = sim_engine
        else:
            self.engine = SweepEngine(
                sim_engine=sim_engine if sim_engine is not None else "auto",
                tracer=tracer, device=device)
        if compile_cache is not None:
            if cache_dir is not None:
                raise ValueError("pass compile_cache= or cache_dir=, not both")
            self.compile_cache = compile_cache
        else:
            self.compile_cache = CompileCache(path=cache_dir)
        if isinstance(sysid, str):
            sysid = SysIdReport.load(sysid)
        if sysid is not None and not hasattr(sysid, "service_times"):
            raise TypeError("sysid must expose a .service_times attribute")
        self.sysid = sysid
        self._pools: Dict[int, PoolHandle] = {}
        # serializes whole sweeps across threads (see `lock`): the
        # engine's callable/host-prep LRUs are not safe under
        # concurrent simulate_batch calls, and a long-lived server
        # drives one session from many request handlers
        self._mu = threading.RLock()
        self.closed = False

    # -- state accessors -------------------------------------------------------
    @property
    def stats(self):
        """Rolled-up `CacheStats` (engine + worker + device counters)."""
        return self.engine.stats

    @property
    def compile_stats(self):
        return self.compile_cache.stats

    @property
    def device(self):
        """The device the session's engine runs on."""
        return self.engine.device

    @property
    def mesh(self):
        """The engine's sweep mesh (None: one device)."""
        return self.engine.mesh

    @property
    def lock(self) -> threading.RLock:
        """The session's sweep guard (reentrant). `prepare` and
        `simulate_batch` take it per call, which serializes the *state
        mutations* of concurrent callers; a caller composing a
        multi-call sweep (prepare, then several `SweepRun.simulate`
        rounds — the search entry points, or a serving loop) holds it
        across the whole sweep so interleaved requests
        cannot thrash the engine's LRUs mid-search."""
        return self._mu

    def pool_handle(self, workers: int) -> PoolHandle:
        """The session-owned worker pool for ``workers`` (lazily
        spawned, reused across this session's sweeps, shut by
        `close()`)."""
        if self.closed:
            raise RuntimeError("session is closed")
        workers = max(int(workers), 1)
        handle = self._pools.get(workers)
        if handle is None:
            handle = self._pools[workers] = PoolHandle(workers)
        return handle

    def live_pools(self) -> int:
        """Worker pools this session has actually spawned (leak probe
        for the open/close-cycle tests)."""
        return sum(1 for h in self._pools.values() if h.live)

    # -- execution -------------------------------------------------------------
    def prepare(self, wfs: Sequence[Workflow], cfgs: Sequence[StorageConfig],
                *, st: Optional[StLike] = None, locality_aware: bool = True,
                compile_workers: Optional[int] = None) -> SweepRun:
        """Hand index-aligned (workflow, config) pairs to the backend;
        the returned `SweepRun` simulates any index subset any number of
        times (scan pass, then exact-verification rounds). ``st``
        defaults to the session's sysid service times."""
        if self.closed:
            raise RuntimeError("session is closed")
        if st is None:
            if self.sysid is None:
                raise ValueError("no service times: pass st= or construct "
                                 "the session with sysid=")
            st = self.sysid.service_times
        with self._mu, self.tracer.span("session.prepare", phase="compile",
                                        candidates=len(wfs)):
            return self.backend.prepare(self, wfs, cfgs, st=st,
                                        locality_aware=locality_aware,
                                        compile_workers=compile_workers)

    def simulate_batch(self, wfs: Sequence[Workflow],
                       cfgs: Sequence[StorageConfig], *,
                       st: Optional[StLike] = None,
                       locality_aware: bool = True, exact: bool = False):
        """One-shot convenience: prepare + simulate every pair."""
        with self._mu:
            return self.prepare(
                wfs, cfgs, st=st,
                locality_aware=locality_aware).simulate(exact=exact)

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        """Shut this session's worker pools and release the engine's
        callable + host-prep LRUs and the device buffers they pin.
        Idempotent; the compile cache's disk entries (if any) survive
        for the next session's warm start."""
        for handle in self._pools.values():
            handle.close()
        self._pools.clear()
        self.engine.release()
        self.closed = True

    def __enter__(self) -> "SweepSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- legacy bridge ---------------------------------------------------------
    @classmethod
    def from_legacy(cls, *, engine: Optional[SweepEngine] = None,
                    compile_cache: Optional[CompileCache] = None,
                    devices=None, workers: Optional[int] = None
                    ) -> "SweepSession":
        """Session semantics for the deprecated ``engine=`` /
        ``compile_cache=`` / ``devices=`` / ``workers=`` kwargs on the
        search entry points and `Predictor`: borrow the default
        session's engine/cache unless given, pick the backend the old
        kwargs implied (``workers`` > 1 beats ``devices``, matching the
        reference's dispatch order), and share the process-wide worker
        fleet. Such sessions are throwaway handles onto borrowed state —
        they are never closed."""
        eng = engine if engine is not None else default_session().engine
        cache = compile_cache if compile_cache is not None \
            else default_session().compile_cache
        n_workers = workers if workers is not None \
            else getattr(eng, "workers", 1)
        n_workers = max(int(n_workers), 1)
        if n_workers > 1:
            backend: ExecutionBackend = MultiprocBackend(n_workers,
                                                         shared_pools=True)
        elif devices is not None:
            backend = ShardedBackend(devices)
        else:
            backend = InlineBackend()
        return cls(backend, engine=eng, compile_cache=cache)


# The one sanctioned process-wide slot: backs default_session() and the
# legacy default_engine()/
# default_compile_cache() shims.
_SESSION: Optional[SweepSession] = None


def default_session() -> SweepSession:
    """Process-wide session: the shared warmth one-shot scripts and the
    legacy entry points rely on. Prefer constructing your own
    `SweepSession` for anything long-lived or concurrent."""
    global _SESSION
    if _SESSION is None:
        _SESSION = SweepSession()
    return _SESSION


def default_engine() -> SweepEngine:
    """Legacy shim: the default session's engine."""
    return default_session().engine


def default_compile_cache() -> CompileCache:
    """Legacy shim: the default session's structure-keyed DAG cache."""
    return default_session().compile_cache
