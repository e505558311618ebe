"""`SweepSession`: one isolated unit of sweep *state* with an explicit
lifecycle — the seam a prediction service or a multi-host launcher
plugs into.

A session gathers everything a sweep touches behind one object, instead
of process-wide singletons that callers would clobber for each other:

    engine         — `SweepEngine`: per-bucket callable LRU + host-prep
                     caches + device + `CacheStats`
    compile_cache  — `CompileCache`: structure-keyed DAG LRU, optionally
                     disk-persisted (``cache_dir=``)
    backend        — `backends.ExecutionBackend`: HOW sweeps run — one
                     constructor argument instead of threaded kwargs
                     (`InlineBackend` is the one ported so far)
    sysid          — optional object with a ``service_times`` attribute
                     (the reference's `SysIdReport`), the session default
                     for `prepare`

Two sessions never interfere: each owns its engine (hence its device and
caches). ``close()`` (or the context manager) releases everything the
session pinned.

`default_session()` is the one sanctioned process-wide accessor — it
backs the legacy `default_engine()` / `default_compile_cache()` shims
and keeps one-shot scripts as convenient as before. Like every entry
point of the port it runs on CUDA and raises when no card is present.
"""
from __future__ import annotations

import threading
from typing import Any, Optional, Sequence

from ...env import DeviceLike
from ...obs.trace import NULL_TRACER
from ..types import StorageConfig, Workflow
from .backends import ExecutionBackend, InlineBackend, StLike, SweepRun
from .compilecache import CompileCache
from .engine import SIM_ENGINES, SweepEngine


class SweepSession:
    """Owns sweep state; delegates execution to its backend.

    ``backend`` defaults to `backends.InlineBackend`. ``engine`` /
    ``compile_cache`` default to fresh private instances (pass the
    default session's to share warmth deliberately); ``cache_dir`` is a
    convenience for a disk-persisted `CompileCache`. ``sysid`` (any
    object with a ``service_times`` attribute) supplies default service
    times for `prepare`. ``tracer`` (an `obs.trace.Tracer`) turns on
    wall-clock span recording across the pipeline — engine buckets and
    backend compile; the `NULL_TRACER` default records nothing and
    changes no behaviour. ``device`` is where a session-built engine
    runs (default ``"cuda"``, raising when no card is present); a
    borrowed ``engine=`` keeps its own device.
    """

    def __init__(self, backend: Optional[ExecutionBackend] = None, *,
                 engine: Optional[SweepEngine] = None,
                 compile_cache: Optional[CompileCache] = None,
                 cache_dir: Optional[str] = None,
                 sysid: Optional[Any] = None,
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
        if sysid is not None and not hasattr(sysid, "service_times"):
            raise TypeError("sysid must expose a .service_times attribute")
        self.sysid = sysid
        # serializes whole sweeps across threads (see `lock`): the
        # engine's callable/host-prep LRUs are not safe under
        # concurrent simulate_batch calls, and a long-lived server
        # drives one session from many request handlers
        self._mu = threading.RLock()
        self.closed = False

    # -- state accessors -------------------------------------------------------
    @property
    def stats(self):
        """The engine's `CacheStats`."""
        return self.engine.stats

    @property
    def compile_stats(self):
        return self.compile_cache.stats

    @property
    def device(self):
        """The device the session's engine runs on."""
        return self.engine.device

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
        """Release the engine's callable + host-prep LRUs and the device
        buffers they pin. Idempotent; the compile cache's disk entries
        (if any) survive for the next session's warm start."""
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
        session's engine/cache unless given. Only the inline backend is
        ported, so ``workers`` > 1 and ``devices`` raise
        `NotImplementedError` instead of picking the multi-process or
        sharded backend. Such sessions are throwaway handles onto
        borrowed state — they are never closed."""
        if workers is not None and int(workers) > 1:
            raise NotImplementedError(
                "workers > 1 needs the multi-process backend, which is "
                "not ported yet")
        if devices is not None:
            raise NotImplementedError(
                "devices= needs the sharded backend, which is not ported "
                "yet")
        eng = engine if engine is not None else default_session().engine
        cache = compile_cache if compile_cache is not None \
            else default_session().compile_cache
        return cls(InlineBackend(), engine=eng, compile_cache=cache)


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
