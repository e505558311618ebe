"""Bucket-cached batched simulation engine — the sweep stack's
*executor*, counterpart of `repro.core.sweep.engine`.

The sweep hot path is a batched simulation of padded DAGs. This engine
owns one callable per ``(n_ops_bucket, n_resources_bucket,
batch_bucket, exact, n_shards, faulted, kernel)`` key, held in a small
LRU. PyTorch runs eagerly, so nothing is compiled here and a callable is
cheap to build; the LRU keeps the reference's keys and hit / miss /
eviction counters all the same, because they are what shows that a
second sweep over a same-bucket grid meets only shapes it has met before
(the acceptance property the tests assert via the counters), and because
the key names the kernel specialisation a bucket runs through.

The engine executes; it does not own policy or lifecycle. *What* runs
where is decided one layer up by an `ExecutionBackend`
(`sweep.backends`: inline / device-sharded / multi-process), and
*state* — which engine, which compile cache, which mesh, which worker
pools — is owned by a `SweepSession` (`sweep.session`). ``set_mesh``
points the engine at an already-resolved device mesh (the
`ShardedBackend` resolves it); bucket batches are then split over the
mesh via `shard.sharded_executable`. Placement is adaptive: a bucket is
split only when it carries at least ``min_shard_oprows`` real op-rows
(candidates x padded op count; `MIN_SHARD_OPROWS` says where the value
comes from), because a small bucket is dispatch-bound and runs slower
split. Batches that don't divide the
device count are padded into the existing power-of-two buckets
(``shard.shard_pad``), never given new keys.

Below the callables sit two caches that keep warm sweeps device-bound
(a cold row's prep — the DAG's copy to the device, its estimated-start
order (`torch_sim.estimated_order`: built on a card there, on a CPU
engine by `scan_order`) and its permuted, padded arrays
(`torch_sim.DeviceOrder.arrays`, on the engine's device) — otherwise
outweighs the simulation itself):

* a **row cache** of prepped `OpArrays`, keyed by (DAG identity, service
  times, ops bucket, exact, dtype) — subset re-sweeps (halving rounds,
  what-if loops) skip the order and padding for every row seen before;
* a **batch cache** of stacked bucket batches, keyed by the row keys —
  an identical re-sweep skips stacking entirely.

Every cache key names the float type (`core.x64.sim_dtype`, f64 or f32
under ``REPRO_SIM_X64=0``), read once per `simulate_batch` call: a batch
never mixes the two, and a sweep after the switch flips meets no entry
of the other type.

Both hold tensors on the engine's device. Counters track exact-mode
usage (the search layer proves it verifies shortlists with one batched
call per round), row/batch cache traffic, which way the ``sim_engine``
dispatch went, and per-slot placement (``device_rows``) so sharded runs
can show where rows actually ran.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...env import DeviceLike, resolve_device
from ...kernels.sweep_scan import ops as sweep_scan_ops
from ...obs.trace import NULL_TRACER
from ..compile import MicroOps
from ..types import ServiceTimes
from ..x64 import sim_dtype
from .. import torch_sim
from .buckets import group_by_bucket
from . import shard as _shard

# key: (n_ops_bucket, n_resources_bucket, batch_bucket, exact, n_shards,
#       faulted, kernel, dtype) — faulted buckets take a third FaultArrays
# argument, so they are a distinct structural class from healthy ones;
# kernel marks scan callables that run the CUDA sweep_scan kernel rather
# than the plain PyTorch loop, dtype the float type of the bucket (the
# kernel's f64 or f32 instantiation). A mesh change keeps only the
# k[4] == 1 entries (`set_mesh`).
CacheKey = Tuple[int, int, int, bool, int, bool, bool, torch.dtype]

# the engine's ``sim_engine`` knob: what a scan-mode bucket runs through.
# "auto" takes the CUDA kernel whenever the engine's device is a CUDA
# device and the plain PyTorch loop otherwise (counted in
# `CacheStats.kernel_fallbacks`); "cuda" insists (raising on a CPU
# engine); "torch" keeps the plain loop. Exact mode always runs the
# PyTorch step loop — the kernel is scan-only.
SIM_ENGINES = ("auto", "cuda", "torch")

# a sharded bucket must carry at least this many real op-rows
# (candidates x padded op count); below it the per-device dispatch
# overhead exceeds the parallelism win. The value is the reference's,
# kept so that placement decisions and cache keys match its: the
# reference measured it on 8 forced CPU host devices (small buckets ran
# 4-15x slower split, large ones 2-5x faster; the boundary sat near 2^15
# op-rows). Nothing here measured it on a GPU.
MIN_SHARD_OPROWS = 32768


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    batch_calls: int = 0          # simulate_batch invocations
    exact_batch_calls: int = 0    # ... with exact=True
    sims: int = 0                 # candidate-simulations served (REQUESTED
                                  # candidates — never the padded row count)
    exact_sims: int = 0
    padded_rows: int = 0          # rows actually simulated incl. padding
    row_hits: int = 0             # prepped-OpArrays cache traffic
    row_misses: int = 0
    orders_on_card: int = 0       # scan-mode rows (row misses) whose order
                                  # the card built
                                  # (`torch_sim.estimated_order`)
    orders_on_host: int = 0       # ... that `torch_sim.scan_order` ordered
                                  # on the host (a CPU engine, a forward
                                  # dep, a duration not finite)
    stack_hits: int = 0           # stacked-bucket-batch cache traffic
    stack_misses: int = 0
    sharded_batch_calls: int = 0  # simulate_batch calls that sharded >= 1 bucket
    device_rows: Dict[str, int] = field(default_factory=dict)
                                  # rows placed per mesh slot (padded),
                                  # sharded only (`shard.slot_names`)
    mp_items: int = 0             # work items dispatched to worker processes
    mp_fallbacks: int = 0         # items a dead worker pushed back in-process
    mp_late_drops: int = 0        # timed-out items whose worker was already
                                  # running (cancel failed): the late result —
                                  # values AND counter rollup — was discarded
                                  # while the item re-ran in-process, so
                                  # worker-counter asserts must not be hard
                                  # while this is nonzero (the late worker may
                                  # also still be writing the shared disk cache)
    kernel_buckets: int = 0       # callables built on the CUDA sweep_scan
                                  # kernel (scan mode, sim_engine auto/cuda)
    kernel_fallbacks: int = 0     # scan batches that wanted the kernel
                                  # (sim_engine="auto") but ran the plain
                                  # PyTorch loop because the engine's device
                                  # is the CPU
    kernel_launches: int = 0      # sweep_scan kernel launches (counted by
                                  # the kernel's wrapper, ops.sweep_scan;
                                  # worker launches roll up from multiproc)
    worker_rows: Dict[str, int] = field(default_factory=dict)
                                  # rows simulated per worker process (padded) —
                                  # the multiproc sibling of device_rows

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


def _make_executable(n_resources: int, exact: bool, faulted: bool = False,
                     kernel: bool = False) -> Callable[..., torch.Tensor]:
    """The callable for one bucket: batched arrays -> makespans ``[C]``.
    In scan mode the durations are a few elementwise PyTorch ops and the
    sequential FIFO recurrence is ONE `sweep_scan` call over the whole
    candidate batch — the CUDA kernel when ``kernel``, else the plain
    loop; element-wise equal either way."""
    def run(batch: torch_sim.OpArrays, st_vecs: torch.Tensor,
            fbatch: Optional[torch_sim.FaultArrays] = None, *,
            stats: Optional["CacheStats"] = None) -> torch.Tensor:
        assert (fbatch is not None) == faulted
        return torch_sim.simulate_arrays(batch, st_vecs,
                                         n_resources=n_resources, exact=exact,
                                         f=fbatch, use_kernel=kernel,
                                         stats=stats)[0]
    return run


class SweepEngine:
    """Bucketed-padding batch simulator with an LRU of per-bucket
    callables.

    ``simulate_batch`` is a drop-in for `torch_sim.simulate_batch` (same
    results) that routes each candidate through its shape bucket rather
    than padding to the batch max.

    ``device`` is where every bucket runs (default ``"cuda"``; the
    constructor raises when no card is present — pass ``device="cpu"``
    for the plain PyTorch path on the host).

    ``devices`` selects sharded execution (`shard.resolve_mesh`
    semantics: None = one device, 0 = all visible devices of the
    engine's type, n = first n, or an explicit device sequence). Sharded
    and unsharded results are element-wise identical
    (tests/test_torch_shard.py). ``min_shard_oprows`` tunes the
    adaptive placement threshold (0 = always shard).

    ``sim_engine`` picks what a scan-mode bucket runs through
    (`SIM_ENGINES`): "auto" launches the CUDA `kernels.sweep_scan`
    kernel on a CUDA engine and runs the plain PyTorch loop on a CPU
    engine (``stats.kernel_fallbacks`` counts that); "cuda" insists;
    "torch" opts out. The two are element-wise identical on every input,
    so the knob is purely a throughput decision — exact mode always runs
    the PyTorch step loop. Kernel launches are counted in
    ``stats.kernel_launches``.

    ``workers`` is the engine's default host-process fan-out: the search
    layer (`explore`/`explore_many`/`successive_halving`) and
    `Predictor.predict_batch` dispatch sweeps through
    `multiproc.MultiprocSweep` when it is > 1 and no per-call
    ``workers=`` overrides it. The engine's own ``simulate_batch`` always
    runs in-process (it receives already-compiled DAGs; the multiproc
    layer dispatches (workflow, config) specs so workers can warm-start
    from the shared disk compile cache) — worker counters roll up into
    this engine's ``stats`` (``worker_rows``, ``mp_items``,
    ``kernel_launches``).
    """

    def __init__(self, max_entries: int = 32, *,
                 devices: _shard.DevicesLike = None,
                 min_shard_oprows: int = MIN_SHARD_OPROWS,
                 max_row_entries: int = 4096,
                 max_stack_entries: int = 32,
                 workers: int = 1,
                 sim_engine: str = "auto",
                 tracer=None,
                 device: DeviceLike = "cuda"):
        if sim_engine not in SIM_ENGINES:
            raise ValueError(f"sim_engine must be one of {SIM_ENGINES}, "
                             f"got {sim_engine!r}")
        self.device = resolve_device(device)
        self.max_entries = max_entries
        self.workers = max(int(workers), 1)
        self.sim_engine = sim_engine
        # wall-clock span recorder (obs.trace) — the no-op NULL_TRACER
        # unless a SweepSession(tracer=...) points it at a live one; the
        # instrumented path is identical either way
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.min_shard_oprows = min_shard_oprows
        self.max_row_entries = max_row_entries
        self.max_stack_entries = max_stack_entries
        self._fns: "OrderedDict[CacheKey, object]" = OrderedDict()
        # row key -> (ops ref, prepped OpArrays, FaultArrays); holding the
        # MicroOps reference pins its id(), keeping the identity-based
        # key sound
        self._rows: "OrderedDict[tuple, tuple]" = OrderedDict()
        # tuple of row keys -> stacked device batch
        self._stacks: "OrderedDict[tuple, object]" = OrderedDict()
        self._mesh = _shard.resolve_mesh(devices, self.device)
        self.stats = CacheStats()

    # -- device placement -----------------------------------------------------
    @property
    def mesh(self) -> Optional[_shard.Mesh]:
        return self._mesh

    @property
    def n_shards(self) -> int:
        return _shard.shard_count(self._mesh)

    def set_mesh(self, mesh: Optional[_shard.Mesh]) -> "SweepEngine":
        """Point the engine at an already-resolved 1-D mesh (or None for
        one device). Sharded callables close over their mesh, so
        changing it drops them; plain (shards=1) entries survive. Mesh
        *resolution* (device counts, lists, pow2 prefixes) lives in the
        backend/session layer — see `shard.resolve_mesh`."""
        if _shard.mesh_identity(mesh) != _shard.mesh_identity(self._mesh):
            self._fns = OrderedDict(
                (k, fn) for k, fn in self._fns.items() if k[4] == 1)
            self._mesh = mesh
        return self

    def bucket_shards(self, n_rows: int, n_ops_bucket: int) -> int:
        """Adaptive placement: shards for a bucket of ``n_rows`` real
        candidates whose DAGs pad to ``n_ops_bucket`` ops. 1 = keep the
        bucket on one device (too little work to split)."""
        if self._mesh is None:
            return 1
        if n_rows * n_ops_bucket < self.min_shard_oprows:
            return 1
        return self.n_shards

    def _use_kernel(self, exact: bool) -> bool:
        """Resolve the ``sim_engine`` knob for one scan batch, before any
        bucket runs. On a CUDA engine "auto" and "cuda" both take the
        kernel (which launches or raises — no fallback from there)."""
        if exact or self.sim_engine == "torch":
            return False
        if sweep_scan_ops.cuda_supported(self.device):
            return True
        if self.sim_engine == "cuda":
            raise RuntimeError(
                "sim_engine='cuda' but the engine runs on device "
                f"{str(self.device)!r}; use 'auto' to fall back to the "
                "plain PyTorch loop")
        self.stats.kernel_fallbacks += 1
        return False

    # -- executable cache ------------------------------------------------------
    def _executable(self, key: CacheKey):
        fn = self._fns.get(key)
        if fn is not None:
            self.stats.hits += 1
            self._fns.move_to_end(key)
            return fn
        self.stats.misses += 1
        fn = _make_executable(n_resources=key[1], exact=key[3],
                              faulted=key[5], kernel=key[6])
        if key[4] > 1:
            fn = _shard.sharded_executable(fn, self._mesh, self.device)
        if key[6]:
            self.stats.kernel_buckets += 1
        self._fns[key] = fn
        if len(self._fns) > self.max_entries:
            self._fns.popitem(last=False)
            self.stats.evictions += 1
        return fn

    def cache_keys(self) -> List[CacheKey]:
        return list(self._fns)

    def cached_batches(self) -> List[Tuple[torch_sim.OpArrays,
                                           Optional[torch_sim.FaultArrays]]]:
        """The stacked bucket batches currently held on the device,
        oldest first (read-only view for diagnostics and kernel
        timing at the shapes a sweep really produced)."""
        return [(b, f) for _, b, f in self._stacks.values()]

    def release(self) -> None:
        """Drop every cached callable and host-prep entry, releasing the
        device buffers they pin. The engine stays usable — the next
        sweep simply rebuilds. `SweepSession.close()` calls this."""
        self._fns.clear()
        self._rows.clear()
        self._stacks.clear()

    # -- host-prep caches ------------------------------------------------------
    def _prepped_row(self, ops: MicroOps, st: ServiceTimes, n_pad: int,
                     r_pad: int, exact: bool, dtype: torch.dtype
                     ) -> Tuple[tuple, torch_sim.OpArrays,
                                Optional[torch_sim.FaultArrays]]:
        """Padded (and, in scan mode, permuted) device-side arrays for
        one DAG — the per-row Python cost a warm sweep must not repay.
        Exact mode never permutes, so its key is service-time free.
        Faulted DAGs also carry their `FaultArrays` (padded to the same
        bucket; ``r_pad`` sizes the multiplier vector, hence its place in
        the key); healthy DAGs carry None. ``dtype`` is what the arrays
        are rounded to, and part of the key."""
        key = (id(ops), n_pad, r_pad, True, dtype) if exact else \
            (id(ops), n_pad, r_pad, False, dtype,
             torch_sim.st_to_vec(st).tobytes())
        hit = self._rows.get(key)
        if hit is not None:
            self.stats.row_hits += 1
            self._rows.move_to_end(key)
            return key, hit[1], hit[2]
        self.stats.row_misses += 1
        order = torch_sim.estimated_order(ops, None if exact else st,
                                          self.device)
        if not exact:
            self.stats.orders_on_card += int(order.on_card)
            self.stats.orders_on_host += int(not order.on_card)
        arr, farr = order.arrays(n_pad, r_pad, dtype=dtype)
        self._rows[key] = (ops, arr, farr)
        if len(self._rows) > self.max_row_entries:
            self._rows.popitem(last=False)
        return key, arr, farr

    def _stacked(self, row_keys: Tuple[tuple, ...], ops: List[MicroOps],
                 arrays: List[torch_sim.OpArrays],
                 farrs: Optional[List[Optional[torch_sim.FaultArrays]]],
                 n_pad: int, r_pad: int, dtype: torch.dtype):
        """Stacked bucket batch; an identical re-sweep skips the stack
        entirely. The entry pins the MicroOps references itself: row
        keys are id()-based, and a row entry may be evicted (releasing
        its pin) while the stack entry survives — a recycled id() must
        not serve a stale batch.

        ``farrs`` is None for all-healthy buckets; in a faulted bucket,
        healthy rows get a shared *neutral* `FaultArrays` (x1.0 / +0.0 —
        exact in f64 and f32, so those rows match the healthy path
        element-wise). The key needs no fault flag and no dtype: row keys
        pin DAG identity and dtype, and a DAG's fault state is part of
        the DAG."""
        hit = self._stacks.get(row_keys)
        if hit is not None:
            self.stats.stack_hits += 1
            self._stacks.move_to_end(row_keys)
            return hit[1], hit[2]
        self.stats.stack_misses += 1
        batch = torch_sim.OpArrays.stack(arrays)
        fbatch = None
        if farrs is not None:
            neutral = torch_sim.FaultArrays.neutral(n_pad, r_pad,
                                                    device=self.device,
                                                    dtype=dtype)
            fbatch = torch_sim.FaultArrays.stack(
                [f if f is not None else neutral for f in farrs])
        self._stacks[row_keys] = (tuple(ops), batch, fbatch)
        if len(self._stacks) > self.max_stack_entries:
            self._stacks.popitem(last=False)
        return batch, fbatch

    # -- simulation -----------------------------------------------------------
    def simulate_one(self, ops: MicroOps, st: ServiceTimes, *,
                     exact: bool = False, timeline: bool = False):
        """One run of one DAG on the engine's device, through the same
        kernel dispatch and counters as a bucket (`torch_sim.simulate`;
        ``timeline=True`` attaches the per-op `obs.timeline.Timeline`).
        Not cached: the search layer calls it for the few best
        candidates of a sweep."""
        return torch_sim.simulate(ops, st, exact=exact, timeline=timeline,
                                  device=self.device,
                                  use_kernel=self._use_kernel(exact),
                                  stats=self.stats)

    def simulate_batch(self, ops_list: Sequence[MicroOps],
                       st_list: Sequence[ServiceTimes], *,
                       exact: bool = False,
                       dtype: Optional[torch.dtype] = None) -> np.ndarray:
        """Makespans for C (DAG, ServiceTimes) pairs, bucketed + cached.
        ``dtype`` (default: `x64.sim_dtype()`, read once here) is the
        float type of every bucket of the call."""
        assert len(ops_list) == len(st_list)
        dtype = sim_dtype() if dtype is None else dtype
        self.stats.batch_calls += 1
        # count REQUESTED candidates; padding is tracked in padded_rows
        self.stats.sims += len(ops_list)
        if exact:
            self.stats.exact_batch_calls += 1
            self.stats.exact_sims += len(ops_list)
        out = np.zeros(len(ops_list))
        if not ops_list:
            return out
        sharded_any = False
        use_kernel = self._use_kernel(exact)
        sim_phase = "exact-verify" if exact else "device-sim"
        with self.tracer.span("simulate_batch", phase=sim_phase,
                              candidates=len(ops_list), exact=exact):
            for (n_pad, r_pad), idxs in group_by_bucket(ops_list).items():
                shards = self.bucket_shards(len(idxs), n_pad)
                sharded_any |= shards > 1
                # remainder handling: the batch bucket is a power of two
                # >= the shard count, so it always divides the mesh —
                # odd batch sizes reuse existing buckets, never mint keys
                c_pad = _shard.shard_pad(len(idxs), shards)
                # one faulted row makes the whole bucket faulted:
                # healthy companions ride along on neutral arrays
                # (exact) rather than splitting the bucket in two
                faulted_b = any(torch_sim.faulted(ops_list[i]) for i in idxs)
                # the span's meta says how many of its rows the card
                # ordered, known only at its end
                t0, on_card0 = self.tracer.clock(), self.stats.orders_on_card
                keyed = [self._prepped_row(ops_list[i], st_list[i],
                                           n_pad, r_pad, exact, dtype)
                         for i in idxs]
                vecs = [torch_sim.st_to_vec(st_list[i]) for i in idxs]
                # pad the batch axis by replicating the first row;
                # the duplicates are sliced off below
                keyed += [keyed[0]] * (c_pad - len(idxs))
                vecs += [vecs[0]] * (c_pad - len(idxs))
                batch, fbatch = self._stacked(
                    tuple(k for k, _, _ in keyed),
                    [ops_list[i] for i in idxs],
                    [a for _, a, _ in keyed],
                    [f for _, _, f in keyed] if faulted_b else None,
                    n_pad, r_pad, dtype)
                st_vecs = torch_sim.st_tensor(np.stack(vecs), self.device,
                                              dtype)
                self.tracer.record(
                    f"prep[{n_pad}x{r_pad}]", t0, self.tracer.clock(),
                    phase="host-prep", rows=len(idxs), faulted=int(faulted_b),
                    on_card=self.stats.orders_on_card - on_card0)
                with self.tracer.span(f"sim[{n_pad}x{r_pad}x{c_pad}]",
                                      phase=sim_phase, rows=len(idxs),
                                      shards=shards, faulted=faulted_b):
                    fn = self._executable((n_pad, r_pad, c_pad, exact,
                                           shards, faulted_b, use_kernel,
                                           dtype))
                    res = fn(batch, st_vecs, fbatch if faulted_b else None,
                             stats=self.stats)
                    # the copy to the host waits for the device result,
                    # so the span covers real execution, not the enqueue
                    out[idxs] = res.cpu().numpy()[:len(idxs)]
                self.stats.padded_rows += c_pad
                if shards > 1:
                    rows_per_slot = c_pad // shards
                    for key in _shard.slot_names(self._mesh):
                        self.stats.device_rows[key] = \
                            self.stats.device_rows.get(key, 0) + rows_per_slot
        if sharded_any:
            self.stats.sharded_batch_calls += 1
        return out
