"""Structure-keyed workflow-compile cache: the DAG-level half of the
two-level caching story.

`SweepEngine` keeps prepared device batches warm across sweeps; after
that, the Python `compile_workflow` call per candidate dominates sweep
time. This layer makes repeat sweeps skip Python DAG construction too:

* `Workflow.fingerprint()` / `StorageConfig.fingerprint()` give a cheap
  structural digest of everything `compile_workflow` reads; the cache
  keys compiled `MicroOps` by ``(wf_fp, cfg_fp, locality_aware)`` in an
  LRU with hit/miss/eviction counters mirroring `engine.CacheStats`.
* `compile_grid` dedupes a candidate grid into structural equivalence
  classes — candidates differing only in knobs that do *not* change the
  DAG (or exact grid duplicates) share one compiled object. Service
  times already vary per candidate via `ServiceTimes` vectors, so sharing
  is sound; `MicroOps` is treated as immutable everywhere downstream.
* Cold classes can optionally compile on a thread pool (``workers=``) —
  compilation is pure Python + numpy, so this overlaps the numpy array
  materialization of independent DAGs.
* ``path=`` persists entries to disk (one ``.npz`` per structural key,
  tagged with a format-version + compiler-constant digest), so cold
  *processes* — CI runs, cron advisors — warm-start from earlier
  processes: a fresh-process repeat of a persisted grid performs zero
  `compile_workflow` executions.

Entries carry this package's own `compiler_digest()` salt, so the port
and the reference never read each other's ``.npz`` files even when they
share a cache directory.

Correctness contract: a cache-served `MicroOps` is bit-identical —
every array and every piece of metadata — to a fresh `compile_workflow`
of the same inputs, and a repeat sweep over the same grid performs zero
compiles.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ...obs.trace import NULL_TRACER
from ..compile import MAXD, MicroOps, compile_workflow
from ..types import CTRL_BYTES, StorageConfig, Workflow

# key: (workflow fingerprint, config fingerprint, locality_aware)
CompileKey = Tuple[str, str, bool]

# -- disk persistence --------------------------------------------------------------
# Serialized entries are tagged with a format version + a digest of the
# compiler parameters that shape a `MicroOps`: any change to the
# emitted-DAG semantics invalidates every persisted entry rather than
# silently serving DAGs a newer compiler would not produce.
_FORMAT_VERSION = 2   # v2: optional fault arrays (res_mult / dead)


def compiler_digest() -> str:
    """Digest of everything besides ``(wf, cfg, locality_aware)`` that
    determines a compiled DAG: the on-disk format version and the
    compiler constants (dep-slot width, control-message size)."""
    blob = json.dumps({"package": "repro_torch", "format": _FORMAT_VERSION,
                       "maxd": MAXD, "ctrl_bytes": CTRL_BYTES},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def compile_key(wf: Workflow, cfg: StorageConfig, *,
                locality_aware: bool = True) -> CompileKey:
    """The structural identity of one `compile_workflow` invocation."""
    return (wf.fingerprint(), cfg.fingerprint(), locality_aware)


_ARRAY_FIELDS = ("res", "cls", "nbytes", "reqs", "extra", "nlat", "deps")
# fault state is None on healthy compiles; persisted only when present
_FAULT_FIELDS = ("res_mult", "dead")


def _entry_path(root: Path, key: CompileKey) -> Path:
    return root / f"{key[0]}-{key[1]}-{int(key[2])}.npz"


def _dump_ops(path: Path, key: CompileKey, ops: MicroOps) -> None:
    """One entry per file; written atomically (per-writer tmp + rename)
    so a sweep killed mid-store never leaves a truncated entry for the
    next process, and racing writers never interleave."""
    meta = {
        "digest": compiler_digest(),
        "key": list(key),
        "n_resources": ops.n_resources,
        "bytes_moved": ops.bytes_moved,
        "storage_used": ops.storage_used,
        "task_end_op": {str(k): v for k, v in ops.task_end_op.items()},
        "stage_of_task": {str(k): v for k, v in ops.stage_of_task.items()},
        "file_write_op": dict(ops.file_write_op),
    }
    arrays = {f: getattr(ops, f) for f in _ARRAY_FIELDS}
    arrays.update({f: getattr(ops, f) for f in _FAULT_FIELDS
                   if getattr(ops, f) is not None})
    buf = io.BytesIO()
    np.savez(buf, meta=np.array(json.dumps(meta, sort_keys=True)), **arrays)
    tmp = path.with_suffix(f".tmp{os.getpid()}_{threading.get_ident()}")
    try:
        tmp.write_bytes(buf.getvalue())
        os.replace(tmp, path)
    except OSError:
        tmp.unlink(missing_ok=True)   # don't strand partial tmp files
        raise


def _load_ops(path: Path, key: CompileKey) -> Optional[MicroOps]:
    """Read one persisted entry; None when missing, stale (compiler
    digest mismatch) or unreadable — a disk miss, never an error."""
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("digest") != compiler_digest() \
                    or meta.get("key") != list(key):
                return None
            arrays = {f: z[f] for f in _ARRAY_FIELDS}
            arrays.update({f: z[f] for f in _FAULT_FIELDS if f in z.files})
    except (OSError, KeyError, ValueError, json.JSONDecodeError):
        return None
    return MicroOps(
        **arrays,
        n_resources=int(meta["n_resources"]),
        task_end_op={int(k): int(v) for k, v in meta["task_end_op"].items()},
        stage_of_task={int(k): str(v)
                       for k, v in meta["stage_of_task"].items()},
        file_write_op={str(k): int(v)
                       for k, v in meta["file_write_op"].items()},
        bytes_moved=int(meta["bytes_moved"]),
        storage_used=int(meta["storage_used"]),
    )


@dataclass
class CompileCacheStats:
    """Mirrors `engine.CacheStats` one level up: DAGs instead of
    executables. ``misses`` equals the number of `compile_workflow`
    executions the cache performed."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    grid_calls: int = 0        # compile_grid invocations
    grid_candidates: int = 0   # candidates routed through compile_grid
    grid_classes: int = 0      # structural equivalence classes seen
    dedup_shared: int = 0      # candidates served by a classmate's DAG
    disk_hits: int = 0         # lookups served from the persistence dir
    disk_stores: int = 0       # entries written to the persistence dir
    worker_compiles: Dict[str, int] = dataclasses.field(default_factory=dict)
                               # compile_workflow executions per worker
                               # process (empty until the multi-process
                               # backend is ported)

    def reset(self) -> None:
        # derived from the dataclass fields, never a hand-maintained
        # tuple: a counter added tomorrow resets without anyone
        # remembering to list it here
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, dict):
                v.clear()
            else:
                setattr(self, f.name, 0)


class CompileCache:
    """LRU of compiled micro-op DAGs keyed by structural fingerprint.

    ``enabled=False`` turns the layer into a counted pass-through (every
    lookup compiles fresh, nothing stored, no dedup) — the off-switch the
    cache-on-vs-off bit-identity tests exercise.

    ``path=`` adds disk persistence beneath the LRU: every compiled
    entry is serialized to that directory keyed by ``(wf_fp, cfg_fp,
    locality_aware)``, tagged with `compiler_digest()`, and memory
    misses fall through to disk before compiling — so cold *processes*
    (CI runs, cron advisors) warm-start from a previous process's work
    with zero `compile_workflow` executions for every structure already
    seen. Stale or truncated files are treated as misses and
    overwritten, never served.
    """

    def __init__(self, max_entries: int = 256, *, enabled: bool = True,
                 path: Optional[Union[str, Path]] = None):
        self.max_entries = max_entries
        self.enabled = enabled
        self._dir: Optional[Path] = Path(path) if path is not None else None
        if self._dir is not None:
            self._dir.mkdir(parents=True, exist_ok=True)
        self._ops: "OrderedDict[CompileKey, MicroOps]" = OrderedDict()
        self.stats = CompileCacheStats()
        # the default cache is process-wide; guard the LRU and counters
        # against concurrent get()/compile_grid() callers (two racing
        # misses may both compile — entries are bit-identical, so the
        # last insert winning is harmless and both compiles are counted)
        self._mu = threading.RLock()

    @property
    def path(self) -> Optional[Path]:
        """The persistence directory (None = memory-only)."""
        return self._dir

    # -- single compile --------------------------------------------------------
    def get(self, wf: Workflow, cfg: StorageConfig, *,
            locality_aware: bool = True) -> MicroOps:
        """Cache-aware `compile_workflow`."""
        if not self.enabled:
            with self._mu:
                self.stats.misses += 1
            return compile_workflow(wf, cfg, locality_aware=locality_aware)
        key = compile_key(wf, cfg, locality_aware=locality_aware)
        ops = self._lookup(key)
        if ops is None:
            ops = compile_workflow(wf, cfg, locality_aware=locality_aware)
            self._insert(key, ops)
        return ops

    # -- grid compile ----------------------------------------------------------
    def compile_grid(self, workflow_for: Callable, candidates: Sequence, *,
                     locality_aware: bool = True,
                     workers: Optional[int] = None,
                     tracer=None) -> List[MicroOps]:
        """Compile a candidate grid, one `compile_workflow` per structural
        equivalence class; every class member shares the class DAG.

        ``candidates`` are `search.Candidate`-likes (anything with a
        ``to_config()``); ``workflow_for(c)`` builds the workflow for
        one candidate. ``workers`` > 1 compiles cold classes on a thread
        pool. Returns one `MicroOps` per candidate, aligned with the
        input order (duplicates are shared references, not copies).
        ``tracer`` records a ``compile_dag`` span (meta ``ops``, ``tasks``
        and `compile_workflow`'s ``counts``: ``bulk_ops`` and the fault
        path's ``faulted``, ``picks``, ``failovers``, ``dead_ops``,
        ``kills``) per `compile_workflow`, under the caller's request id
        on the pool's threads too.
        """
        tracer = NULL_TRACER if tracer is None else tracer
        with self._mu:
            self.stats.grid_calls += 1
            self.stats.grid_candidates += len(candidates)
        wfs = [workflow_for(c) for c in candidates]
        cfgs = [c.to_config() for c in candidates]
        # a request scope is thread-local: carry it into the pool's threads
        rid = tracer.current_request()
        scope = {} if rid is None else {"req": rid}

        def build(i: int) -> MicroOps:
            t0 = tracer.clock()
            counts: Dict[str, int] = {}
            ops = compile_workflow(wfs[i], cfgs[i],
                                   locality_aware=locality_aware,
                                   counts=counts)
            tracer.record("compile_dag", t0, tracer.clock(), phase="compile",
                          ops=ops.n_ops, tasks=len(wfs[i].tasks), **counts,
                          **scope)
            return ops

        def build_many(idxs: Sequence[int]) -> List[MicroOps]:
            if workers is not None and workers > 1 and len(idxs) > 1:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    return list(pool.map(build, idxs))
            return [build(i) for i in idxs]

        if not self.enabled:
            with self._mu:
                self.stats.misses += len(candidates)
            return build_many(range(len(candidates)))

        # memoize per distinct Workflow object: multi-workflow sweeps pass
        # the same fixed workflow for every candidate, and re-hashing a
        # trace-scale task list per (workflow, candidate) pair is O(pairs
        # x tasks) redundant host work (wfs pins the id()s for the call)
        wf_fp: Dict[int, str] = {}

        def fp(w: Workflow) -> str:
            v = wf_fp.get(id(w))
            if v is None:
                v = wf_fp[id(w)] = w.fingerprint()
            return v

        keys = [(fp(w), c.fingerprint(), locality_aware)
                for w, c in zip(wfs, cfgs)]
        classes: "OrderedDict[CompileKey, int]" = OrderedDict()  # key -> rep idx
        for i, k in enumerate(keys):
            classes.setdefault(k, i)
        with self._mu:
            self.stats.grid_classes += len(classes)
            self.stats.dedup_shared += len(candidates) - len(classes)

        served: Dict[CompileKey, MicroOps] = {}
        cold: List[Tuple[CompileKey, int]] = []
        for k, i in classes.items():
            ops = self._lookup(k)
            if ops is None:
                cold.append((k, i))
            else:
                served[k] = ops

        compiled = build_many([i for _, i in cold])
        for (k, _), ops in zip(cold, compiled):
            self._insert(k, ops)
            served[k] = ops
        return [served[k] for k in keys]

    # -- LRU internals ---------------------------------------------------------
    def _lookup(self, key: CompileKey) -> Optional[MicroOps]:
        with self._mu:
            ops = self._ops.get(key)
            if ops is not None:
                self.stats.hits += 1
                self._ops.move_to_end(key)
                return ops
        if self._dir is not None:
            # memory miss -> disk: a previous process's compile serves
            # this one (an LRU-evicted entry also comes back this way)
            ops = _load_ops(_entry_path(self._dir, key), key)
            if ops is not None:
                self._remember(key, ops)
                with self._mu:
                    self.stats.hits += 1
                    self.stats.disk_hits += 1
                return ops
        return None

    def _remember(self, key: CompileKey, ops: MicroOps) -> None:
        # freeze the arrays: cached DAGs are shared by reference, and an
        # in-place edit by one caller would silently poison every later
        # sweep that hits the same structural key
        for f in _ARRAY_FIELDS:
            getattr(ops, f).setflags(write=False)
        for f in _FAULT_FIELDS:
            if getattr(ops, f) is not None:
                getattr(ops, f).setflags(write=False)
        with self._mu:
            self._ops[key] = ops
            if len(self._ops) > self.max_entries:
                self._ops.popitem(last=False)
                self.stats.evictions += 1

    def _insert(self, key: CompileKey, ops: MicroOps) -> None:
        with self._mu:
            self.stats.misses += 1
        self._remember(key, ops)
        if self._dir is not None:
            # best-effort, like the read side: a full disk or read-only
            # cache dir must not abort the sweep that tried to warm it
            try:
                _dump_ops(_entry_path(self._dir, key), key, ops)
            except OSError:
                return
            with self._mu:
                self.stats.disk_stores += 1

    def cache_keys(self) -> List[CompileKey]:
        with self._mu:
            return list(self._ops)

    def clear(self) -> None:
        with self._mu:
            self._ops.clear()
