"""Multi-process host fan-out for grid sweeps, counterpart of
`repro.core.sweep.multiproc`.

`shard` splits a sweep's candidate batch axis across local *devices*;
this layer fans the work out across host *processes*, so the
pure-Python DAG compiles that dominate a cold sweep run on several
cores instead of one thread under the interpreter lock. A
`MultiprocSweep` partitions a sweep's (workflow x candidate) pairs into
work items at **structural-class** granularity (every member of a class
shares one compiled DAG, hence one shape bucket — classes are never
split across items, so a cold fleet compiles each class exactly once)
and feeds them through a spawn-based work queue of N worker processes.

Each worker owns one `SweepEngine` per device it has been sent work
for, plus a per-path registry of `CompileCache`s, so workers
**warm-start from the shared on-disk cache**: when the parent's
`CompileCache` has a ``path=``, a worker's first encounter with a class
is a disk hit — zero `compile_workflow` executions for structures any
previous process (or sibling worker) already compiled. Service times are shipped per item, either as a
`ServiceTimes` value or as a `SysIdServiceTimes` reference that workers
resolve once from the persisted `SysIdReport` cache. The parent
engine's device travels in every item too: a parent on ``cuda`` gets
workers that launch the sweep-scan kernel there, a CPU parent gets CPU
workers, and no worker picks a device for itself (a worker asked for
``cuda`` on a host without a card raises, and the item falls back to
the parent, counted in `CacheStats.mp_fallbacks`). Workers are always
*spawned*: the parent holds a CUDA context, which a forked child cannot
use. Worker results are NumPy arrays, never device tensors.

Merging is deterministic: makespans are scattered back into stable
candidate-index order (values are per-(DAG, service-times) and therefore
independent of how the queue interleaved items), per-worker engine and
compile-cache counters are rolled up into the parent's stats
(`CacheStats.worker_rows`, `CompileCacheStats.worker_compiles`, and the
kernel's launches in `CacheStats.kernel_launches`), and a work item
whose worker dies falls back to the in-process engine instead of
failing the sweep. ``workers <= 1`` never touches multiprocessing at
all — the search layer degrades to the plain in-process path.

Pool ownership comes in two flavours. A session-constructed
`MultiprocBackend` runs on the session's own `PoolHandle`, torn down by
`SweepSession.close()`. The legacy ``workers=`` kwargs borrow from a
process-wide shared fleet keyed by worker count and reused across sweeps
(spawn + torch import costs seconds per worker; pools are fungible
because every sweep-specific datum travels in the item payload). Tests
that need memory-cold workers call `shutdown_pools()` first.
"""
from __future__ import annotations

import atexit
import multiprocessing
import os
import time
from collections import OrderedDict
from concurrent.futures import BrokenExecutor, ProcessPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...kernels.sweep_scan import kernel as sweep_scan_kernel
from ...obs.trace import NULL_TRACER, Tracer, WireSpan
from ..compile import compile_count
from ..sysid import SysIdReport
from ..types import ServiceTimes, StorageConfig, Workflow
from ..x64 import sim_dtype
from .compilecache import CompileCache
from .engine import SweepEngine

# engine / compile-cache counters that roll up from workers by summation
_ENGINE_ROLLUP = ("hits", "misses", "evictions", "batch_calls",
                  "exact_batch_calls", "sims", "exact_sims", "padded_rows",
                  "row_hits", "row_misses", "orders_on_card",
                  "orders_on_host", "stack_hits", "stack_misses",
                  "kernel_buckets", "kernel_fallbacks", "kernel_launches")
_CACHE_ROLLUP = ("hits", "misses", "evictions", "disk_hits", "disk_stores")

# work items per worker the partitioner aims for: >1 so the queue can
# load-balance classes of uneven weight, small enough that per-item
# dispatch (pickle + IPC) stays negligible next to the simulation
CHUNKS_PER_WORKER = 2

# worker-side compile-cache capacity: a sweep routinely carries more
# structural classes than the default LRU (256) holds, and an LRU
# cycled in class order by repeated rounds thrashes — every lookup
# would evict the entry the next round needs (measured: a "warm" 432
# -class item re-ran every compile). Size it for whole sweeps.
WORKER_CACHE_ENTRIES = 8192


@dataclass(frozen=True)
class SysIdServiceTimes:
    """Reference to a persisted `SysIdReport`: workers resolve it from
    the sysid disk cache themselves (one `SysIdReport.load` per worker,
    memoized) instead of unpickling a `ServiceTimes` from the parent —
    the sysid half of the warm-start story."""

    path: str

    def resolve(self) -> ServiceTimes:
        return SysIdReport.load(self.path).service_times


StLike = Union[ServiceTimes, SysIdServiceTimes]


def resolve_st(st: StLike) -> ServiceTimes:
    """Materialize a service-times spec (parent-side / fallback path)."""
    return st.resolve() if isinstance(st, SysIdServiceTimes) else st


def partition_weighted(weights: Sequence[int], n_items: int) -> List[List[int]]:
    """Split ``range(len(weights))`` into at most ``n_items`` contiguous,
    non-empty runs of near-equal total weight (deterministic; preserves
    order so same-structure classes stay adjacent). The atoms are whole
    classes — a class is never split across items."""
    n = len(weights)
    if n == 0:
        return []
    n_items = max(1, min(n_items, n))
    total = sum(weights)
    items: List[List[int]] = []
    cum = 0.0
    cur: List[int] = []
    for i, w in enumerate(weights):
        cur.append(i)
        cum += w
        # close the run once it reaches its proportional share, keeping
        # enough atoms back that every remaining item stays non-empty
        if len(items) < n_items - 1 and n - i - 1 >= n_items - len(items) - 1 \
                and cum >= total * (len(items) + 1) / n_items:
            items.append(cur)
            cur = []
    if cur:
        items.append(cur)
    return items


# -- worker side -------------------------------------------------------------------
# Spawned workers import this module fresh; globals below are populated
# once per process by `_worker_init` and reused across work items.

_W: dict = {}


def _worker_name() -> str:
    name = multiprocessing.current_process().name
    digits = "".join(ch for ch in name if ch.isdigit())
    return f"w{digits or os.getpid()}"


def _worker_init() -> None:
    # one intra-op thread per worker: N workers on an M-core host each
    # running PyTorch's default pool (one thread per core) thrash each
    # other's threads, and a worker's CPU work is the Python compile
    # loop and small per-step tensor ops that one thread serves best
    torch.set_num_threads(1)
    _W["engines"] = {}             # device string -> SweepEngine
    _W["caches"] = OrderedDict()   # cache path (or None) -> CompileCache
    _W["st_memo"] = {}   # (path, mtime, size) -> ServiceTimes
    _W["name"] = _worker_name()


# distinct cache directories a worker keeps warm at once: pools are
# process-wide and outlive individual sweeps, so an unbounded per-path
# registry would pin every finished sweep's DAGs in worker memory
# (tmp dirs in CI, rotating advisor --cache-dir)
WORKER_CACHE_PATHS = 4


def _worker_cache(path: Optional[str]) -> CompileCache:
    caches: "OrderedDict[Optional[str], CompileCache]" = _W["caches"]
    cache = caches.get(path)
    if cache is None:
        cache = caches[path] = CompileCache(
            max_entries=WORKER_CACHE_ENTRIES, path=path)
    caches.move_to_end(path)
    while len(caches) > WORKER_CACHE_PATHS:
        caches.popitem(last=False)
    return cache


def _worker_st(st: StLike) -> ServiceTimes:
    if isinstance(st, SysIdServiceTimes):
        # memo keyed by the report file's identity, not just its path: a
        # rewritten report (re-identification against new hardware) must
        # refresh here, or the fleet would serve stale service times
        # while the parent's fallback path loads the new ones
        try:
            meta = os.stat(st.path)
            key = (st.path, meta.st_mtime_ns, meta.st_size)
        except OSError:
            key = (st.path, None, None)
        memo = _W["st_memo"]
        hit = memo.get(key)
        if hit is None:
            for stale in [k for k in memo if k[0] == st.path]:
                del memo[stale]         # at most one live entry per path
            hit = memo[key] = st.resolve()
        return hit
    return st


def _worker_engine(device: str) -> SweepEngine:
    """This worker's engine for ``device`` (one per device string,
    built on first use; `resolve_device` raises for ``cuda`` on a host
    without a card)."""
    engines: Dict[str, SweepEngine] = _W["engines"]
    engine = engines.get(device)
    if engine is None:
        engine = engines[device] = SweepEngine(device=device)
    return engine


def _int_snapshot(stats, fields) -> Dict[str, int]:
    return {f: getattr(stats, f) for f in fields}


def _worker_run(item_id: int,
                parts: List[Tuple[Workflow, StorageConfig, int]],
                st: StLike, locality_aware: bool,
                cache_path: Optional[str], exact: bool,
                sim_engine: str = "auto", trace: bool = False,
                device: str = "cuda",
                dtype: Optional[torch.dtype] = None):
    """Execute one work item: compile-or-load each class DAG through the
    shared disk cache, simulate every member row in one engine call on
    the worker's engine for ``device`` (the parent engine's device), and
    report makespans (NumPy) plus counter deltas for the parent's
    rollup.
    ``sim_engine`` travels in the payload (pools outlive sweeps, so the
    worker engine re-points its scan body per item; the executable cache
    key carries the flag, so switching never serves a stale build), and
    so does ``dtype``, the parent's `x64.sim_dtype()` for the sweep (a
    worker's environment is the one it was spawned with).
    ``trace`` hangs a fresh item-local `Tracer` on the engine: its spans
    ship back as `WireSpan` tuples relative to the item's start, for the
    parent to re-base onto its own clock (`Tracer.absorb`)."""
    engine = _worker_engine(device)
    engine.sim_engine = sim_engine
    local = Tracer(track=_W["name"]) if trace else NULL_TRACER
    engine.tracer = local
    cache = _worker_cache(cache_path)
    st_val = _worker_st(st)
    n0 = compile_count()
    e0 = _int_snapshot(engine.stats, _ENGINE_ROLLUP)
    c0 = _int_snapshot(cache.stats, _CACHE_ROLLUP)
    try:
        ops_list = []
        with local.span(f"compile_or_load[item{item_id}]", phase="compile",
                        classes=len(parts)):
            for wf, cfg, count in parts:
                ops = cache.get(wf, cfg, locality_aware=locality_aware)
                ops_list.extend([ops] * count)
        values = engine.simulate_batch(ops_list, [st_val] * len(ops_list),
                                       exact=exact, dtype=dtype)
    finally:
        engine.tracer = NULL_TRACER   # never leak an item-local tracer
    e_delta = {f: getattr(engine.stats, f) - e0[f] for f in _ENGINE_ROLLUP}
    c_delta = {f: getattr(cache.stats, f) - c0[f] for f in _CACHE_ROLLUP}
    return (item_id, np.asarray(values), _W["name"], e_delta, c_delta,
            compile_count() - n0, local.wire_spans())


# -- worker pools ------------------------------------------------------------------

def _spawn_pool(workers: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(
        max_workers=workers,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_worker_init)


class PoolHandle:
    """One owned worker pool with lazy spawn, respawn-on-broken, and
    explicit shutdown — the unit of pool ownership a `SweepSession`
    holds (its ``close()`` calls ``close`` here, replacing the
    process-wide `shutdown_pools` footgun for session users)."""

    def __init__(self, workers: int):
        self.workers = max(int(workers), 1)
        self._pool: Optional[ProcessPoolExecutor] = None
        self.closed = False

    def executor(self) -> ProcessPoolExecutor:
        if self.closed:
            raise RuntimeError("worker pool handle is closed")
        if self._pool is None:
            self._pool = _spawn_pool(self.workers)
        return self._pool

    def respawn(self) -> None:
        """Discard a broken pool; the next `executor()` spawns fresh."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    @property
    def live(self) -> bool:
        return self._pool is not None

    def close(self) -> None:
        self.respawn()
        self.closed = True


# Legacy shared fleet: pools keyed by worker count, reused across sweeps
# (spawn + torch import costs seconds per worker; every sweep datum
# travels in the item payload, so pools are fungible). The legacy
# `workers=` kwargs borrow from here; session-owned `MultiprocBackend`s
# hold their own `PoolHandle` instead. Torn down atexit.
_POOLS: Dict[int, ProcessPoolExecutor] = {}


def _get_pool(workers: int) -> ProcessPoolExecutor:
    pool = _POOLS.get(workers)
    if pool is None:
        pool = _POOLS[workers] = _spawn_pool(workers)
    return pool


def shutdown_pools() -> None:
    """Tear down every *shared* worker pool (tests use this to force
    memory-cold workers; also registered atexit). Session-owned pools
    are closed by `SweepSession.close()` instead."""
    for pool in _POOLS.values():
        pool.shutdown(wait=False, cancel_futures=True)
    _POOLS.clear()


atexit.register(shutdown_pools)


# -- parent side -------------------------------------------------------------------

class MultiprocSweep:
    """One sweep's worth of (workflow, config) pairs, dispatchable to a
    worker fleet any number of times (scan pass, then exact-verification
    rounds) — the multi-process analogue of `SweepEngine.simulate_batch`.

    ``wfs``/``cfgs`` are index-aligned (one entry per candidate or per
    (workflow x candidate) pair). Construction fingerprints the pairs
    into structural classes and mirrors `CompileCache.compile_grid`'s
    grid counters on the parent cache; nothing is compiled parent-side —
    workers compile (or disk-load) their own classes.

    `simulate` returns makespans element-wise identical to the
    in-process engine (tests/test_torch_multiproc.py), in stable candidate
    -index order regardless of queue interleaving. A failed work item
    (dead worker, broken pool, or — with ``item_timeout_s`` set — one
    that exceeds its deadline) falls back to the in-process engine, on
    the parent's device; without a timeout the parent waits for slow
    items, relying on the caller's own backstop.
    ``item_timeout_s`` bounds each item's round-trip **from submit**:
    the merge loop waits only the remaining budget per item, so a merge
    over N items with one hung worker completes in O(timeout), not
    O(N x timeout). A broken pool is respawned exactly once per
    dispatch; a timed-out item whose worker was already running is
    counted in `CacheStats.mp_late_drops` (the late result, including
    its counter rollup, is discarded — see the field's caveats).

    ``pool=`` runs the sweep on a caller-owned `PoolHandle` (the
    session-owned path); the default borrows the process-wide shared
    fleet keyed by worker count.
    """

    def __init__(self, wfs: Sequence[Workflow], cfgs: Sequence[StorageConfig],
                 *, st: StLike, workers: int, locality_aware: bool = True,
                 engine: Optional[SweepEngine] = None,
                 cache: Optional[CompileCache] = None,
                 item_timeout_s: Optional[float] = None,
                 pool: Optional[PoolHandle] = None,
                 tracer=None):
        assert len(wfs) == len(cfgs)
        self.workers = max(int(workers), 1)
        self.locality_aware = locality_aware
        self.st = st
        self.item_timeout_s = item_timeout_s
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if engine is None or cache is None:
            from .session import default_session  # lazy: session imports us
            sess = default_session()
            engine = engine if engine is not None else sess.engine
            cache = cache if cache is not None else sess.compile_cache
        self.engine = engine
        self.cache = cache
        self.pool = pool
        self.wfs = list(wfs)
        self.cfgs = list(cfgs)
        self.cache_path = \
            str(self.cache.path) if self.cache.path is not None else None

        # structural identity per index (workflow fingerprints memoized
        # per object, as in compile_grid — re-hashing a trace-scale task
        # list per pair is O(pairs x tasks) redundant host work)
        wf_fp: Dict[int, str] = {}

        def fp(w: Workflow) -> str:
            v = wf_fp.get(id(w))
            if v is None:
                v = wf_fp[id(w)] = w.fingerprint()
            return v

        self.keys = [(fp(w), c.fingerprint(), locality_aware)
                     for w, c in zip(self.wfs, self.cfgs)]
        classes: "OrderedDict[tuple, int]" = OrderedDict()   # key -> rep idx
        for i, k in enumerate(self.keys):
            classes.setdefault(k, i)
        self.class_rep = classes
        s = self.cache.stats
        with self.cache._mu:
            s.grid_calls += 1
            s.grid_candidates += len(self.wfs)
            s.grid_classes += len(classes)
            s.dedup_shared += len(self.wfs) - len(classes)

    # -- dispatch ---------------------------------------------------------------
    def _build_items(self, idxs: Sequence[int]):
        """Group ``idxs`` by structural class (classes stay whole), then
        partition the class list into contiguous weighted work items."""
        groups: "OrderedDict[tuple, List[int]]" = OrderedDict()
        for i in idxs:
            groups.setdefault(self.keys[i], []).append(i)
        class_list = list(groups.items())
        runs = partition_weighted([len(m) for _, m in class_list],
                                  self.workers * CHUNKS_PER_WORKER)
        items = []
        for run in runs:
            parts = [(self.wfs[self.class_rep[class_list[c][0]]],
                      self.cfgs[self.class_rep[class_list[c][0]]],
                      len(class_list[c][1])) for c in run]
            members = [i for c in run for i in class_list[c][1]]
            items.append((parts, members))
        return items

    def _fallback(self, parts, exact: bool,
                  dtype: Optional[torch.dtype] = None) -> np.ndarray:
        """In-process execution of one item (worker died / pool broken):
        the parent's cache and engine serve it (on the parent's device,
        through the same kernel dispatch), so the sweep completes with
        identical results, just without that item's parallelism."""
        self.engine.stats.mp_fallbacks += 1
        ops_list = []
        for wf, cfg, count in parts:
            ops = self.cache.get(wf, cfg, locality_aware=self.locality_aware)
            ops_list.extend([ops] * count)
        st_val = resolve_st(self.st)
        return self.engine.simulate_batch(ops_list, [st_val] * len(ops_list),
                                          exact=exact, dtype=dtype)

    def _roll_up(self, wname: str, e_delta: Dict[str, int],
                 c_delta: Dict[str, int], n_compiles: int) -> None:
        es, cs = self.engine.stats, self.cache.stats
        for f, v in e_delta.items():
            setattr(es, f, getattr(es, f) + v)
        es.worker_rows[wname] = \
            es.worker_rows.get(wname, 0) + e_delta["padded_rows"]
        with self.cache._mu:
            for f, v in c_delta.items():
                setattr(cs, f, getattr(cs, f) + v)
            cs.worker_compiles[wname] = \
                cs.worker_compiles.get(wname, 0) + n_compiles

    def simulate(self, idxs: Optional[Sequence[int]] = None, *,
                 exact: bool = False) -> np.ndarray:
        """Makespans for ``idxs`` (default: every pair), aligned with the
        requested order. Dispatches the class-partitioned work items to
        the shared pool and merges deterministically."""
        if idxs is None:
            idxs = range(len(self.wfs))
        idxs = list(idxs)
        out = np.zeros(len(idxs))
        if not idxs:
            return out
        pos = {i: p for p, i in enumerate(idxs)}
        items = self._build_items(idxs)
        self.engine.stats.mp_items += len(items)
        tr = self.tracer
        device = str(self.engine.device)
        dtype = sim_dtype()               # one float type for every item
        if (not exact and self.engine.sim_engine != "torch"
                and self.engine.device.type == "cuda"):
            # build the kernel library here, once, before the fleet runs:
            # workers then load the file from disk instead of each
            # running nvcc on a cold build directory
            sweep_scan_kernel.load()
        try:
            pool = self.pool.executor() if self.pool is not None \
                else _get_pool(self.workers)
        except RuntimeError:              # closed session handle
            pool = None
        futures = []
        submit_at: List[float] = []       # tracer-clock submit instants
                                          # (span re-basing floor)
        submit_wall: List[float] = []     # wall-clock submit instants: the
                                          # item_timeout_s deadline base —
                                          # each item's clock starts at
                                          # submit, not when the merge loop
                                          # reaches it (tr.now() is 0 on the
                                          # NULL_TRACER, so deadlines never
                                          # ride the tracer clock)
        with tr.span("mp.dispatch", phase="dispatch",
                     items=len(items), exact=exact):
            for item_id, (parts, _) in enumerate(items):
                submit_at.append(tr.now())
                submit_wall.append(time.monotonic())
                if pool is None:
                    futures.append(None)
                    continue
                try:
                    futures.append(pool.submit(
                        _worker_run, item_id, parts, self.st,
                        self.locality_aware, self.cache_path, exact,
                        self.engine.sim_engine, tr.enabled, device, dtype))
                except RuntimeError:      # pool shut down under us
                    futures.append(None)
        pool_broken = False               # one respawn per dispatch generation
        with tr.span("mp.merge", phase="merge", items=len(items),
                     exact=exact):
            for item_id, ((parts, members), fut) in \
                    enumerate(zip(items, futures)):
                result = None
                # once the dispatch generation is broken, only harvest
                # futures that already completed — every pending future
                # belongs to the dead pool and will never run, so waiting
                # on it (or respawning again per item) is pure churn
                if fut is not None and (not pool_broken or fut.done()):
                    # only the worker round-trip is guarded: a parent-side
                    # failure (rollup, ordering assert) should surface, not
                    # be masked as a fallback that re-simulates the item
                    try:
                        if self.item_timeout_s is None:
                            result = fut.result()
                        else:
                            # the deadline clock starts at SUBMIT: pass the
                            # remaining budget, not the full timeout, or a
                            # merge over N items with one hung worker
                            # stretches to N x timeout (each later item's
                            # clock would only start when the merge loop
                            # reached it)
                            left = self.item_timeout_s \
                                - (time.monotonic() - submit_wall[item_id])
                            result = fut.result(timeout=max(0.0, left))
                    except BrokenExecutor:
                        # dead worker: shut the broken pool down exactly
                        # once (its healthy siblings would otherwise leak
                        # as live processes) so the next sweep spawns
                        # fresh; this item and every remaining one from
                        # the same generation finish in-process
                        if not pool_broken:
                            pool_broken = True
                            if self.pool is not None:
                                self.pool.respawn()
                            else:
                                stale = _POOLS.pop(self.workers, None)
                                if stale is not None:
                                    stale.shutdown(wait=False,
                                                   cancel_futures=True)
                    except FuturesTimeout:
                        # deadline expired with a healthy fleet: keep the
                        # pool, run just this item in-process. cancel()
                        # succeeds only if the worker has not started; a
                        # running worker's eventual result is DROPPED
                        # (values and counter rollup both) — count it, so
                        # worker-counter asserts know to stand down
                        if not fut.cancel():
                            self.engine.stats.mp_late_drops += 1
                    except Exception:
                        # per-item failure (unpicklable payload, worker
                        # exception): keep the pool, fall back in-process
                        # — and cancel so a not-yet-started item isn't
                        # also computed remotely
                        fut.cancel()
                if result is not None:
                    (rid, values, wname, e_delta, c_delta, n_comp,
                     spans) = result
                    assert rid == item_id
                    self._roll_up(wname, e_delta, c_delta, n_comp)
                    if spans:
                        # the worker's clock is its item start; anchor it
                        # so the item's last span ends at the parent-side
                        # receive instant, never earlier than its submit.
                        # Absorbing in this (item-id) order keeps the
                        # merged sequence deterministic regardless of how
                        # the queue interleaved workers.
                        w_end = max(s + d for _, s, d, _, _ in spans)
                        tr.absorb(spans, track=wname,
                                  offset=max(tr.now() - w_end,
                                             submit_at[item_id]))
                else:
                    values = self._fallback(parts, exact, dtype)
                for i, v in zip(members, values):
                    out[pos[i]] = float(v)
        return out


class MultiprocBackend:
    """`backends.ExecutionBackend` running sweeps across a host-process
    fleet: ``prepare`` returns a `MultiprocSweep` on the session's
    engine and compile cache.

    By default the fleet is *session-owned* — workers come from the
    session's `PoolHandle` for this worker count, so
    `SweepSession.close()` tears them down. ``shared_pools=True`` borrows
    the process-wide shared fleet instead (the legacy ``workers=`` kwargs
    use this: pools are fungible across sweeps, and per-call spawn costs
    seconds per worker).
    """

    def __init__(self, workers: int, *,
                 item_timeout_s: Optional[float] = None,
                 shared_pools: bool = False):
        self.workers = max(int(workers), 1)
        self.item_timeout_s = item_timeout_s
        self.shared_pools = shared_pools

    def prepare(self, session, wfs: Sequence[Workflow],
                cfgs: Sequence[StorageConfig], *, st: StLike,
                locality_aware: bool = True,
                compile_workers: Optional[int] = None) -> "MultiprocSweep":
        # compile_workers is a thread-pool knob for the inline path;
        # here each worker process compiles (or disk-loads) its own
        # classes, so it does not apply
        pool = None if self.shared_pools else session.pool_handle(self.workers)
        return MultiprocSweep(wfs, cfgs, st=st, workers=self.workers,
                              locality_aware=locality_aware,
                              engine=session.engine,
                              cache=session.compile_cache,
                              item_timeout_s=self.item_timeout_s, pool=pool,
                              tracer=session.tracer)
