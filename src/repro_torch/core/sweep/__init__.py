"""The sweep subsystem: grid -> shortlist -> verify over storage
configurations, organized as state (session) x policy (backend) over
two cache levels (docs/sweep.md, docs/architecture.md §5):

    compilecache — `CompileCache`: structure-keyed LRU of compiled
                   micro-op DAGs + grid dedup into equivalence classes
    buckets      — power-of-two shape bucketing of compiled DAGs
    engine       — `SweepEngine`: LRU of per-bucket callables + host-prep
                   caches + counters, on one device
    backends     — `ExecutionBackend` protocol and `InlineBackend`
    session      — `SweepSession`: engine + compile cache + sysid behind
                   one lifecycle (`close()`); the single sanctioned
                   process-wide slot is `default_session()`
    search       — Candidate grids, explore/pareto/successive-halving

The reference's `shard` and `multiproc` modules (and their backends) are
not ported yet.
"""
from .backends import ExecutionBackend, InlineBackend, SweepRun
from .buckets import bucket_of, bucket_pow2, group_by_bucket
from .compilecache import (CompileCache, CompileCacheStats, compile_key,
                           compiler_digest)
from .engine import SIM_ENGINES, CacheStats, SweepEngine
from .search import (Candidate, Evaluation, explore, explore_many, grid,
                     pareto_front, successive_halving, with_faults)
from .session import (SweepSession, default_compile_cache, default_engine,
                      default_session)

__all__ = [
    "ExecutionBackend", "InlineBackend", "SweepRun",
    "bucket_of", "bucket_pow2", "group_by_bucket",
    "CompileCache", "CompileCacheStats", "compile_key", "compiler_digest",
    "SIM_ENGINES", "CacheStats", "SweepEngine",
    "Candidate", "Evaluation", "explore", "explore_many", "grid",
    "pareto_front", "successive_halving", "with_faults",
    "SweepSession", "default_session", "default_engine",
    "default_compile_cache",
]
