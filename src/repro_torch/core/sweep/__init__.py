"""The sweep subsystem: grid -> shortlist -> verify over storage
configurations, organized as state (session) x policy (backend) over
two cache levels (docs/sweep.md, docs/architecture.md §5):

    compilecache — `CompileCache`: structure-keyed LRU of compiled
                   micro-op DAGs + grid dedup into equivalence classes
    buckets      — power-of-two shape bucketing of compiled DAGs
    engine       — `SweepEngine`: LRU of per-bucket callables + host-prep
                   caches + counters, on one device or a mesh
    shard        — candidate-batch-axis split over a 1-D device mesh
    multiproc    — host-process fan-out of structural-class work items
    backends     — `ExecutionBackend` protocol: Inline / Sharded /
                   Multiproc policies producing identical results
    session      — `SweepSession`: engine + compile cache + mesh + pools
                   + sysid behind one lifecycle (`close()`); the single
                   sanctioned process-wide slot is `default_session()`
    search       — Candidate grids, explore (one question or a batch of
                   them in one sweep)/pareto/successive-halving
"""
from .backends import ExecutionBackend, InlineBackend, ShardedBackend, SweepRun
from .buckets import bucket_of, bucket_pow2, group_by_bucket
from .compilecache import (CompileCache, CompileCacheStats, compile_key,
                           compiler_digest)
from .engine import SIM_ENGINES, CacheStats, SweepEngine
from .multiproc import (MultiprocBackend, MultiprocSweep, PoolHandle,
                        SysIdServiceTimes, partition_weighted, shutdown_pools)
from .search import (Candidate, Evaluation, Question, explore, explore_batch,
                     explore_many, grid, pareto_front, successive_halving,
                     with_faults)
from .session import (SweepSession, default_compile_cache, default_engine,
                      default_session)
from .shard import resolve_mesh, shard_count

__all__ = [
    "ExecutionBackend", "InlineBackend", "ShardedBackend", "SweepRun",
    "bucket_of", "bucket_pow2", "group_by_bucket",
    "CompileCache", "CompileCacheStats", "compile_key", "compiler_digest",
    "SIM_ENGINES", "CacheStats", "SweepEngine",
    "MultiprocBackend", "MultiprocSweep", "PoolHandle",
    "SysIdServiceTimes", "partition_weighted", "shutdown_pools",
    "Candidate", "Evaluation", "Question", "explore", "explore_batch",
    "explore_many", "grid",
    "pareto_front", "successive_halving", "with_faults",
    "SweepSession", "default_session", "default_engine",
    "default_compile_cache",
    "resolve_mesh", "shard_count",
]
