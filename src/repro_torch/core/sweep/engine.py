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
(`sweep.backends`), and *state* — which engine, which compile cache —
is owned by a `SweepSession` (`sweep.session`). Device sharding of the
candidate axis is not ported yet: ``n_shards`` is always 1.

Below the callables sit two caches that keep warm sweeps device-bound
(the Python prep — `scan_order` + padding + host->device transfer —
otherwise dwarfs the simulation itself):

* a **row cache** of prepped `OpArrays`, keyed by (DAG identity, service
  times, ops bucket, exact) — subset re-sweeps (halving rounds, what-if
  loops) skip `scan_order` and padding for every row seen before;
* a **batch cache** of stacked bucket batches, keyed by the row keys —
  an identical re-sweep skips stacking entirely.

Both hold tensors on the engine's device. Counters track exact-mode
usage (the search layer proves it verifies shortlists with one batched
call per round), row/batch cache traffic, and which way the
``sim_engine`` dispatch went.
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
from .. import torch_sim
from .buckets import bucket_pow2, group_by_bucket

# key: (n_ops_bucket, n_resources_bucket, batch_bucket, exact, n_shards,
#       faulted, kernel) — faulted buckets take a third FaultArrays
# argument, so they are a distinct structural class from healthy ones;
# kernel marks scan callables that run the CUDA sweep_scan kernel rather
# than the plain PyTorch loop. n_shards is always 1 until the sharded
# backend is ported; the slot is kept so keys read the same in both
# packages.
CacheKey = Tuple[int, int, int, bool, int, bool, bool]

# the engine's ``sim_engine`` knob: what a scan-mode bucket runs through.
# "auto" takes the CUDA kernel whenever the engine's device is a CUDA
# device and the plain PyTorch loop otherwise (counted in
# `CacheStats.kernel_fallbacks`); "cuda" insists (raising on a CPU
# engine); "torch" keeps the plain loop. Exact mode always runs the
# PyTorch step loop — the kernel is scan-only.
SIM_ENGINES = ("auto", "cuda", "torch")


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
    stack_hits: int = 0           # stacked-bucket-batch cache traffic
    stack_misses: int = 0
    sharded_batch_calls: int = 0  # simulate_batch calls that sharded >= 1
                                  # bucket (0 until sharding is ported)
    device_rows: Dict[str, int] = field(default_factory=dict)
                                  # rows placed per device (padded), sharded only
    mp_items: int = 0             # work items dispatched to worker processes
    mp_fallbacks: int = 0         # items a dead worker pushed back in-process
    mp_late_drops: int = 0        # timed-out items whose late result was
                                  # discarded (0 until multiproc is ported)
    kernel_buckets: int = 0       # callables built on the CUDA sweep_scan
                                  # kernel (scan mode, sim_engine auto/cuda)
    kernel_fallbacks: int = 0     # scan batches that wanted the kernel
                                  # (sim_engine="auto") but ran the plain
                                  # PyTorch loop because the engine's device
                                  # is the CPU
    worker_rows: Dict[str, int] = field(default_factory=dict)
                                  # rows simulated per worker process (padded)

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
            fbatch: Optional[torch_sim.FaultArrays] = None) -> torch.Tensor:
        assert (fbatch is not None) == faulted
        return torch_sim.simulate_arrays(batch, st_vecs,
                                         n_resources=n_resources, exact=exact,
                                         f=fbatch, use_kernel=kernel)[0]
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

    ``sim_engine`` picks what a scan-mode bucket runs through
    (`SIM_ENGINES`): "auto" launches the CUDA `kernels.sweep_scan`
    kernel on a CUDA engine and runs the plain PyTorch loop on a CPU
    engine (``stats.kernel_fallbacks`` counts that); "cuda" insists;
    "torch" opts out. The two are element-wise identical, so the knob is
    purely a throughput decision — exact mode always runs the PyTorch
    step loop.
    """

    def __init__(self, max_entries: int = 32, *,
                 max_row_entries: int = 4096,
                 max_stack_entries: int = 32,
                 sim_engine: str = "auto",
                 tracer=None,
                 device: DeviceLike = "cuda"):
        if sim_engine not in SIM_ENGINES:
            raise ValueError(f"sim_engine must be one of {SIM_ENGINES}, "
                             f"got {sim_engine!r}")
        self.device = resolve_device(device)
        self.max_entries = max_entries
        self.sim_engine = sim_engine
        # wall-clock span recorder (obs.trace) — the no-op NULL_TRACER
        # unless a SweepSession(tracer=...) points it at a live one; the
        # instrumented path is identical either way
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.max_row_entries = max_row_entries
        self.max_stack_entries = max_stack_entries
        self._fns: "OrderedDict[CacheKey, object]" = OrderedDict()
        # row key -> (ops ref, prepped OpArrays, FaultArrays); holding the
        # MicroOps reference pins its id(), keeping the identity-based
        # key sound
        self._rows: "OrderedDict[tuple, tuple]" = OrderedDict()
        # tuple of row keys -> stacked device batch
        self._stacks: "OrderedDict[tuple, object]" = OrderedDict()
        self.stats = CacheStats()

    # -- device placement -----------------------------------------------------
    @property
    def n_shards(self) -> int:
        """Always 1: device sharding is not ported yet."""
        return 1

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
                     r_pad: int, exact: bool
                     ) -> Tuple[tuple, torch_sim.OpArrays,
                                Optional[torch_sim.FaultArrays]]:
        """Padded (and, in scan mode, permuted) device-side arrays for
        one DAG — the per-row Python cost a warm sweep must not repay.
        Exact mode never permutes, so its key is service-time free.
        Faulted DAGs also carry their `FaultArrays` (padded to the same
        bucket; ``r_pad`` sizes the multiplier vector, hence its place in
        the key); healthy DAGs carry None."""
        key = (id(ops), n_pad, r_pad, True) if exact else \
            (id(ops), n_pad, r_pad, False, torch_sim.st_to_vec(st).tobytes())
        hit = self._rows.get(key)
        if hit is not None:
            self.stats.row_hits += 1
            self._rows.move_to_end(key)
            return key, hit[1], hit[2]
        self.stats.row_misses += 1
        perm = None if exact else torch_sim.scan_order(ops, st)
        arr = torch_sim.OpArrays.from_micro_ops(ops, pad_to=n_pad, perm=perm,
                                                device=self.device)
        farr = (torch_sim.FaultArrays.from_micro_ops(
                    ops, n_resources=r_pad, pad_to=n_pad, perm=perm,
                    device=self.device)
                if torch_sim.faulted(ops) else None)
        self._rows[key] = (ops, arr, farr)
        if len(self._rows) > self.max_row_entries:
            self._rows.popitem(last=False)
        return key, arr, farr

    def _stacked(self, row_keys: Tuple[tuple, ...], ops: List[MicroOps],
                 arrays: List[torch_sim.OpArrays],
                 farrs: Optional[List[Optional[torch_sim.FaultArrays]]],
                 n_pad: int, r_pad: int):
        """Stacked bucket batch; an identical re-sweep skips the stack
        entirely. The entry pins the MicroOps references itself: row
        keys are id()-based, and a row entry may be evicted (releasing
        its pin) while the stack entry survives — a recycled id() must
        not serve a stale batch.

        ``farrs`` is None for all-healthy buckets; in a faulted bucket,
        healthy rows get a shared *neutral* `FaultArrays` (x1.0 / +0.0 —
        exact in f64, so those rows match the healthy path element-wise).
        The key needs no fault flag: row keys pin DAG identity, and a
        DAG's fault state is part of the DAG."""
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
                                                    device=self.device)
            fbatch = torch_sim.FaultArrays.stack(
                [f if f is not None else neutral for f in farrs])
        self._stacks[row_keys] = (tuple(ops), batch, fbatch)
        if len(self._stacks) > self.max_stack_entries:
            self._stacks.popitem(last=False)
        return batch, fbatch

    # -- simulation -----------------------------------------------------------
    def simulate_batch(self, ops_list: Sequence[MicroOps],
                       st_list: Sequence[ServiceTimes], *,
                       exact: bool = False) -> np.ndarray:
        """Makespans for C (DAG, ServiceTimes) pairs, bucketed + cached."""
        assert len(ops_list) == len(st_list)
        self.stats.batch_calls += 1
        # count REQUESTED candidates; padding is tracked in padded_rows
        self.stats.sims += len(ops_list)
        if exact:
            self.stats.exact_batch_calls += 1
            self.stats.exact_sims += len(ops_list)
        out = np.zeros(len(ops_list))
        if not ops_list:
            return out
        use_kernel = self._use_kernel(exact)
        sim_phase = "exact-verify" if exact else "device-sim"
        with self.tracer.span("simulate_batch", phase=sim_phase,
                              candidates=len(ops_list), exact=exact):
            for (n_pad, r_pad), idxs in group_by_bucket(ops_list).items():
                # the batch bucket is a power of two, so odd batch sizes
                # reuse existing buckets instead of minting new keys
                c_pad = bucket_pow2(len(idxs), 1)
                with self.tracer.span(f"prep[{n_pad}x{r_pad}]",
                                      phase="host-prep", rows=len(idxs)):
                    keyed = [self._prepped_row(ops_list[i], st_list[i],
                                               n_pad, r_pad, exact)
                             for i in idxs]
                    vecs = [torch_sim.st_to_vec(st_list[i]) for i in idxs]
                    # one faulted row makes the whole bucket faulted:
                    # healthy companions ride along on neutral arrays
                    # (exact) rather than splitting the bucket in two
                    faulted_b = any(f is not None for _, _, f in keyed)
                    # pad the batch axis by replicating the first row;
                    # the duplicates are sliced off below
                    keyed += [keyed[0]] * (c_pad - len(idxs))
                    vecs += [vecs[0]] * (c_pad - len(idxs))
                    batch, fbatch = self._stacked(
                        tuple(k for k, _, _ in keyed),
                        [ops_list[i] for i in idxs],
                        [a for _, a, _ in keyed],
                        [f for _, _, f in keyed] if faulted_b else None,
                        n_pad, r_pad)
                    st_vecs = torch.from_numpy(np.stack(vecs)).to(self.device)
                with self.tracer.span(f"sim[{n_pad}x{r_pad}x{c_pad}]",
                                      phase=sim_phase, rows=len(idxs),
                                      shards=1, faulted=faulted_b):
                    fn = self._executable((n_pad, r_pad, c_pad, exact,
                                           1, faulted_b, use_kernel))
                    res = fn(batch, st_vecs, fbatch) if faulted_b \
                        else fn(batch, st_vecs)
                    # the copy to the host waits for the device result,
                    # so the span covers real execution, not the enqueue
                    out[idxs] = res.cpu().numpy()[:len(idxs)]
                self.stats.padded_rows += c_pad
        return out
