"""PyTorch implementation of the queue-based storage model — the
counterpart of `repro.core.jax_sim`.

The compiled micro-op DAG has static shape, so a simulation is a fixed
recurrence over tensors, and a *batch* of configurations and service
times is the same recurrence with a leading candidate axis. Where the
reference maps one-candidate functions over a batch, this module writes
the candidate axis out: every internal function (`_durations`,
`_sim_scan`, `_sim_exact`, `simulate_arrays`) takes tensors shaped
``[C, ...]``, and the single-run entry point adds ``C = 1``.

Modes
-----
* ``exact=True``  — bit-exact DES: repeatedly serve the unscheduled op
  with minimal ready time (ties by op id), identical semantics to
  `ref_sim.simulate`. O(N^2) work as a Python loop of N steps of small
  tensor ops; used for validation and small runs.
* ``exact=False`` — FIFO arrival order approximated by estimated-start
  order: one pass of the sweep-scan recurrence
  (`kernels.sweep_scan`: the CUDA kernel on a CUDA device, the plain
  PyTorch loop on the CPU). Exact whenever that order agrees with ready
  order — true for the symmetric fan-out/fan-in patterns of workflow
  benchmarks — and within a few percent otherwise (tested).

Service times enter as a 7-vector per candidate, so "what-if" hardware
sweeps (§2.1: e.g. SSDs) reuse one prepared DAG.

Everything is f64 (times in seconds need more than f32's 7 digits to
reproduce the oracle's FIFO tie-breaking); every constructor below
names ``dtype=torch.float64`` because `torch.zeros(n)` alone is f32.
Each arithmetic step is its own eager PyTorch op, in the reference's
order, so scan-mode results are element-wise equal to the reference's
(no fused multiply-add can creep in).

Entry points take ``device`` (default ``"cuda"``) and raise when no
card is present; ``device="cpu"`` runs the same code on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..env import DeviceLike, resolve_device
from ..kernels.sweep_scan import ops as sweep_scan_ops
from .compile import (CLS_CLIENT, CLS_MANAGER, CLS_NET_LOCAL, CLS_NET_REMOTE,
                      CLS_STORAGE, N_CLS, MicroOps)
from .faults import DEAD_TIME
from .ref_sim import durations as _ref_durations
from .types import PAPER_RAMDISK, RunReport, ServiceTimes

# service-time vector layout
(ST_NET_REMOTE, ST_NET_LOCAL, ST_NET_LATENCY, ST_STORAGE, ST_MANAGER,
 ST_CLIENT, ST_STORAGE_REQ) = range(7)

F64 = torch.float64


def st_to_vec(st: ServiceTimes) -> np.ndarray:
    return np.array([st.net_remote, st.net_local, st.net_latency,
                     st.storage, st.manager, st.client, st.storage_req],
                    dtype=np.float64)


def _rates(st_vecs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class byte and request rates, ``[C, N_CLS]`` each, from
    service-time vectors ``[C, 7]``."""
    C = st_vecs.shape[0]
    brate = torch.zeros((C, N_CLS), dtype=st_vecs.dtype, device=st_vecs.device)
    brate[:, CLS_NET_REMOTE] = st_vecs[:, ST_NET_REMOTE]
    brate[:, CLS_NET_LOCAL] = st_vecs[:, ST_NET_LOCAL]
    brate[:, CLS_STORAGE] = st_vecs[:, ST_STORAGE]
    rrate = torch.zeros((C, N_CLS), dtype=st_vecs.dtype, device=st_vecs.device)
    rrate[:, CLS_MANAGER] = st_vecs[:, ST_MANAGER]
    rrate[:, CLS_CLIENT] = st_vecs[:, ST_CLIENT]
    rrate[:, CLS_STORAGE] = st_vecs[:, ST_STORAGE_REQ]
    return brate, rrate


def _fields(obj, names) -> tuple:
    return tuple(getattr(obj, n) for n in names)


@dataclass
class OpArrays:
    """Device-side compiled DAG (possibly padded for batching). Built
    per DAG with shapes ``[N]`` / ``[N, MAXD]``; `stack` / `batched` /
    `expand` add the leading candidate axis the simulator works on."""

    res: torch.Tensor      # i32[N]   (the sweep-scan kernel reads i32)
    cls: torch.Tensor      # i64[N]   (an index tensor: int8 cannot index)
    nbytes: torch.Tensor   # f64[N]
    reqs: torch.Tensor     # f64[N]
    extra: torch.Tensor    # f64[N]
    nlat: torch.Tensor     # f64[N]
    deps: torch.Tensor     # i32[N, MAXD]

    _NAMES = ("res", "cls", "nbytes", "reqs", "extra", "nlat", "deps")

    @classmethod
    def from_micro_ops(cls, ops: MicroOps, pad_to: Optional[int] = None,
                       perm: Optional[np.ndarray] = None, *,
                       device: DeviceLike = "cuda") -> "OpArrays":
        dev = resolve_device(device)
        n = ops.n_ops
        m = pad_to or n
        assert m >= n

        def prep(a, fill=0, dtype=None):
            a = a[perm] if perm is not None else a
            out = np.full((m,) + a.shape[1:], fill, dtype=dtype or a.dtype)
            out[:n] = a
            return torch.from_numpy(out).to(dev)

        deps = ops.deps
        if perm is not None:
            inv = np.empty(n, dtype=np.int32)
            inv[perm] = np.arange(n, dtype=np.int32)
            deps = np.where(deps >= 0, inv[deps], -1).astype(np.int32)

        return cls(res=prep(ops.res),
                   cls=prep(ops.cls, dtype=np.int64),
                   nbytes=prep(ops.nbytes),
                   reqs=prep(ops.reqs),
                   extra=prep(ops.extra),
                   nlat=prep(ops.nlat),
                   deps=prep(deps, fill=-1))

    @classmethod
    def stack(cls, rows: Sequence["OpArrays"]) -> "OpArrays":
        """Candidate-major batch of equally shaped rows."""
        return cls(*(torch.stack([getattr(r, n) for r in rows])
                     for n in cls._NAMES))

    def batched(self) -> "OpArrays":
        """This DAG as a batch of one."""
        return OpArrays(*(t[None] for t in _fields(self, self._NAMES)))

    def expand(self, c: int) -> "OpArrays":
        """This DAG repeated ``c`` times along a new candidate axis
        (materialised: the kernel wants contiguous rows)."""
        return OpArrays(*(t[None].expand(c, *t.shape).contiguous()
                          for t in _fields(self, self._NAMES)))


@dataclass
class FaultArrays:
    """Device-side fault scenario, shaped to ride the same batch as
    `OpArrays` (docs/faults.md): a per-resource service-time multiplier
    and a per-op death mask. `None` stands in for the healthy case
    everywhere — the healthy path never materialises these tensors."""

    res_mult: torch.Tensor   # f64[R] service-time multiplier per resource
    dead: torch.Tensor       # f64[N] 1.0 = unservable op (costs DEAD_TIME)

    _NAMES = ("res_mult", "dead")

    @classmethod
    def from_micro_ops(cls, ops: MicroOps, n_resources: Optional[int] = None,
                       pad_to: Optional[int] = None,
                       perm: Optional[np.ndarray] = None, *,
                       device: DeviceLike = "cuda") -> "FaultArrays":
        """Padded/permuted fault arrays matching an `OpArrays` built with
        the same ``pad_to``/``perm``. Padded resources multiply by 1 and
        padded ops are alive, so padding stays inert."""
        dev = resolve_device(device)
        R = n_resources or ops.n_resources
        n, m = ops.n_ops, pad_to or ops.n_ops
        rm = np.ones(R, dtype=np.float64)
        if ops.res_mult is not None:
            rm[:ops.n_resources] = ops.res_mult
        dd = np.zeros(m, dtype=np.float64)
        if ops.dead is not None:
            dd[:n] = ops.dead[perm] if perm is not None else ops.dead
        return cls(res_mult=torch.from_numpy(rm).to(dev),
                   dead=torch.from_numpy(dd).to(dev))

    @classmethod
    def neutral(cls, n_ops: int, n_resources: int, *,
                device: DeviceLike = "cuda") -> "FaultArrays":
        """All-ones / all-zeros arrays for healthy rows batched alongside
        faulted ones: multiplying by 1.0 and adding 0.0 are exact in
        f64, so a healthy row simulated through the faulted path is
        element-wise identical to the healthy path's result."""
        dev = resolve_device(device)
        return cls(res_mult=torch.ones(n_resources, dtype=F64, device=dev),
                   dead=torch.zeros(n_ops, dtype=F64, device=dev))

    @classmethod
    def stack(cls, rows: Sequence["FaultArrays"]) -> "FaultArrays":
        return cls(*(torch.stack([getattr(r, n) for r in rows])
                     for n in cls._NAMES))

    def batched(self) -> "FaultArrays":
        return FaultArrays(self.res_mult[None], self.dead[None])

    def expand(self, c: int) -> "FaultArrays":
        return FaultArrays(*(t[None].expand(c, *t.shape).contiguous()
                             for t in _fields(self, self._NAMES)))


def faulted(ops: MicroOps) -> bool:
    """Does this compiled DAG carry fault state the simulator must apply?"""
    return ops.res_mult is not None or ops.dead is not None


def _scan_order_loop(ops: MicroOps, dur: np.ndarray) -> np.ndarray:
    """Estimated start per op, one op at a time in array order (a dep
    that points at a later op reads 0.0)."""
    n = ops.n_ops
    est_end = np.zeros(n)
    est_start = np.zeros(n)
    deps, ends = ops.deps, est_end
    for i in range(n):
        s = 0.0
        for d in deps[i]:
            if d >= 0 and ends[d] > s:
                s = ends[d]
        est_start[i] = s
        ends[i] = s + dur[i]
    return est_start


def _scan_order_levels(ops: MicroOps, dur: np.ndarray) -> np.ndarray:
    """The same estimated starts, one DAG level at a time in NumPy.
    Needs every dep to point at an earlier op (what the compiler
    emits); then each op's value is the same ``max`` and ``+`` of the
    same operands as in the loop, so the result is bit-equal. A
    paper-scale BLAST DAG has some 600k ops in under 40 levels."""
    n = ops.n_ops
    deps = ops.deps
    valid = deps >= 0
    indeg = valid.sum(axis=1)
    # children in CSR form: edge (dep -> op) for every filled dep slot
    src = deps[valid]
    dst = np.nonzero(valid)[0]
    order = np.argsort(src, kind="stable")
    child = dst[order]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=ptr[1:])
    est_end = np.zeros(n)
    est_start = np.zeros(n)
    frontier = np.flatnonzero(indeg == 0)
    while frontier.size:
        d = deps[frontier]
        s = np.where(d >= 0, est_end[np.maximum(d, 0)], 0.0).max(axis=1)
        s = np.maximum(s, 0.0)
        est_start[frontier] = s
        est_end[frontier] = s + dur[frontier]
        lo, hi = ptr[frontier], ptr[frontier + 1]
        cnt = hi - lo
        total = int(cnt.sum())
        if total == 0:
            break
        # concatenated child ranges [lo_k, hi_k) of the frontier's ops
        starts = np.repeat(lo - np.concatenate(([0], np.cumsum(cnt)[:-1])), cnt)
        kids = child[starts + np.arange(total)]
        indeg -= np.bincount(kids, minlength=n)
        kids = np.unique(kids)
        frontier = kids[indeg[kids] == 0]
    return est_start


def scan_order(ops: MicroOps, st_ref: ServiceTimes) -> np.ndarray:
    """Permutation of ops into contention-free estimated-start order.

    One forward pass computes each op's earliest start ignoring queueing;
    a stable sort on (est_start, op id) then approximates the arrival
    order at every FIFO resource. Computed against a *reference*
    ServiceTimes — the simulated times stay fully parameterized, only the
    serving order is frozen (tested to stay within a few percent of the
    exact-order oracle; use exact=True when it must be bit-faithful).

    Host-side NumPy throughout, the stable sort included. The forward
    pass runs level by level when every dep points at an earlier op and
    falls back to the op-by-op loop otherwise; both give the same
    permutation (tests/test_torch_core.py)."""
    dur = _ref_durations(ops, st_ref) + ops.nlat * st_ref.net_latency
    n = ops.n_ops
    if n and bool((ops.deps < np.arange(n, dtype=ops.deps.dtype)[:, None]).all()):
        est_start = _scan_order_levels(ops, dur)
    else:
        est_start = _scan_order_loop(ops, dur)
    return np.argsort(est_start, kind="stable").astype(np.int32)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[c, idx[c, ...]]`` for every candidate ``c``."""
    flat = idx.reshape(idx.shape[0], -1).to(torch.int64)
    return table.gather(1, flat).reshape(idx.shape)


def _durations(a: OpArrays, st_vecs: torch.Tensor,
               f: Optional[FaultArrays] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-op service durations and network lags, ``[C, N]`` each."""
    brate, rrate = _rates(st_vecs)
    dur = a.nbytes * _take(brate, a.cls) + a.reqs * _take(rrate, a.cls) + a.extra
    if f is not None:
        # degraded/straggler resources serve slower; unservable ops cost
        # DEAD_TIME (finite — see faults.py — so exact-mode min-ready
        # ordering and f64 sums stay well-defined)
        dur = dur * _take(f.res_mult, a.res) + f.dead * DEAD_TIME
    lag = a.nlat * st_vecs[:, ST_NET_LATENCY:ST_NET_LATENCY + 1]
    return dur, lag


# Refinement passes re-sort the serving order by the previous pass's ready
# times. The reference found that this helps pure fan-out patterns but
# *oscillates* for chained pipelines — the iteration is not a
# contraction. Default is therefore 1 (host estimated-start order only);
# use exact=True when the schedule must be oracle-faithful, or the
# sweep->verify workflow in `sweep.search` (scan-mode shortlist,
# exact-mode confirmation).
SCAN_REFINE_PASSES = 1


def _scan_once(a: OpArrays, dur: torch.Tensor, lag: torch.Tensor,
               n_resources: int, use_kernel: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    # the FIFO serving recurrence itself lives in kernels/sweep_scan:
    # the CUDA kernel for CUDA tensors, the plain loop for CPU tensors
    # (or everywhere with use_kernel=False)
    return sweep_scan_ops.sweep_scan(
        a.res.contiguous(), dur.contiguous(), lag.contiguous(),
        a.deps.contiguous(), n_resources=n_resources, use_kernel=use_kernel)


def _permute(a: OpArrays, order: torch.Tensor) -> Tuple[OpArrays, torch.Tensor]:
    """Reorder every candidate's ops by ``order [C, N]``; deps are
    renumbered through the inverse permutation, which is returned."""
    C, n = a.res.shape
    inv = torch.zeros((C, n), dtype=order.dtype, device=order.device)
    inv.scatter_(1, order, torch.arange(n, dtype=order.dtype,
                                        device=order.device).expand(C, n))
    deps = a.deps.gather(1, order[:, :, None].expand(-1, -1, a.deps.shape[2]))
    none = torch.full((), -1, dtype=inv.dtype, device=inv.device)
    deps = torch.where(deps >= 0, _take(inv, deps.clamp(min=0)),
                       none).to(a.deps.dtype)
    return OpArrays(res=a.res.gather(1, order), cls=a.cls.gather(1, order),
                    nbytes=a.nbytes.gather(1, order),
                    reqs=a.reqs.gather(1, order),
                    extra=a.extra.gather(1, order),
                    nlat=a.nlat.gather(1, order), deps=deps), inv


def _sim_scan(a: OpArrays, st_vecs: torch.Tensor, n_resources: int,
              f: Optional[FaultArrays] = None, *, use_kernel: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fast mode: serve each FIFO resource in scan order. The initial
    order (host-side `scan_order`) approximates arrival order; refinement
    passes re-sort by the *actual* start times of the previous pass,
    converging to a self-consistent FIFO schedule."""
    dur, lag = _durations(a, st_vecs, f)
    makespan, end = _scan_once(a, dur, lag, n_resources, use_kernel)
    total_inv = None
    cur = a
    for _ in range(SCAN_REFINE_PASSES - 1):
        # DES serves in READY-time order: recompute each op's ready time
        # from the previous pass's completion times and re-sort.
        dep_end = torch.where(cur.deps >= 0, _take(end, cur.deps.clamp(min=0)),
                              torch.zeros((), dtype=end.dtype, device=end.device))
        ready = dep_end.max(dim=2).values
        order = torch.sort(ready, dim=1, stable=True).indices
        cur, inv = _permute(cur, order)
        total_inv = inv if total_inv is None else inv.gather(1, total_inv)
        # durations are per-op, so permuting them == recomputing from the
        # permuted arrays (and it keeps the fault mask aligned for free)
        dur, lag = dur.gather(1, order), lag.gather(1, order)
        makespan, end = _scan_once(cur, dur, lag, n_resources, use_kernel)
    if total_inv is not None:
        end = end.gather(1, total_inv)
    return makespan, end


def _sim_exact(a: OpArrays, st_vecs: torch.Tensor, n_resources: int,
               f: Optional[FaultArrays] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact mode: global min-ready-time service order (== ref_sim). A
    Python loop of N steps, each a handful of tensor ops over
    ``[C, N, MAXD]``; `torch.argmin` returns the first (lowest-id) of
    equal keys, which is the tie rule the DES needs."""
    C, n = a.res.shape
    dev = a.res.device
    dur, lag = _durations(a, st_vecs, f)
    inf = torch.full((), torch.finfo(dur.dtype).max, dtype=dur.dtype, device=dev)
    zero = torch.zeros((), dtype=dur.dtype, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)
    has_dep = a.deps >= 0                                        # [C, N, MAXD]
    dep_idx = a.deps.clamp(min=0).to(torch.int64).reshape(C, -1)
    res_idx = a.res.to(torch.int64)

    avail = torch.zeros((C, n_resources), dtype=dur.dtype, device=dev)
    end = torch.zeros((C, n), dtype=dur.dtype, device=dev)
    done = torch.zeros((C, n), dtype=torch.bool, device=dev)
    makespan = torch.zeros((C,), dtype=dur.dtype, device=dev)
    for _ in range(n):
        dep_end = torch.where(has_dep, end.gather(1, dep_idx).view_as(has_dep), zero)
        dep_done = torch.where(has_dep, done.gather(1, dep_idx).view_as(has_dep), true)
        frontier = dep_done.all(dim=2) & ~done
        ready = dep_end.max(dim=2).values
        key = torch.where(frontier, ready, inf)
        i = key.argmin(dim=1, keepdim=True)                      # ties -> lowest id
        r = res_idx.gather(1, i)
        start = torch.maximum(ready.gather(1, i), avail.gather(1, r))
        fin = start + dur.gather(1, i)
        avail.scatter_(1, r, fin)
        end.scatter_(1, i, fin + lag.gather(1, i))
        done.scatter_(1, i, true.expand(C, 1))
        makespan = torch.maximum(makespan, fin.squeeze(1))
    return makespan, end


def simulate_arrays(a: OpArrays, st_vecs: torch.Tensor, *, n_resources: int,
                    exact: bool = False, f: Optional[FaultArrays] = None,
                    use_kernel: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched arrays in, (makespan [C], per-op completion times incl.
    lag [C, N]) out. ``f=None`` is the healthy path and never touches
    fault tensors. ``use_kernel`` only matters in scan mode."""
    if exact:
        return _sim_exact(a, st_vecs, n_resources, f)
    return _sim_scan(a, st_vecs, n_resources, f, use_kernel=use_kernel)


def _st_tensor(vecs: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float64)).to(dev)


def simulate(ops: MicroOps, st: ServiceTimes, *, exact: bool = False,
             timeline: bool = False, device: DeviceLike = "cuda") -> RunReport:
    """Drop-in equivalent of `ref_sim.simulate` running on ``device``.

    ``timeline=True`` (the per-op schedule attached to the report) is
    not part of the port yet and raises `NotImplementedError`."""
    if timeline:
        raise NotImplementedError(
            "timeline=True needs obs.timeline, which is not ported yet")
    dev = resolve_device(device)
    perm = None if exact else scan_order(ops, st)
    a = OpArrays.from_micro_ops(ops, perm=perm, device=dev).batched()
    fa = (FaultArrays.from_micro_ops(ops, perm=perm, device=dev).batched()
          if faulted(ops) else None)
    makespan, end = simulate_arrays(a, _st_tensor(st_to_vec(st)[None], dev),
                                    n_resources=ops.n_resources, exact=exact,
                                    f=fa)
    makespan = float(makespan[0].cpu())
    end = end[0].cpu().numpy()
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
        end = end[inv]
    per_task = {tid: float(end[op]) for tid, op in ops.task_end_op.items()}
    per_stage: Dict[str, float] = {}
    for tid, t_end in per_task.items():
        s = ops.stage_of_task.get(tid, "")
        per_stage[s] = max(per_stage.get(s, 0.0), t_end)
    return RunReport(makespan=makespan, bytes_moved=ops.bytes_moved,
                     storage_used=ops.storage_used, per_task_end=per_task,
                     per_stage_end=per_stage, n_events=ops.n_ops)


# --- batched configuration sweeps (beyond-paper) -----------------------------------

def simulate_batch(ops_list: Sequence[MicroOps], st_list: Sequence[ServiceTimes],
                   *, exact: bool = False, device: DeviceLike = "cuda"
                   ) -> np.ndarray:
    """Simulate C configurations in one batched call.

    Pads every DAG to the batch max op count and resource count; padded
    ops are zero-duration no-ops on the dummy resource. A fault axis
    rides along: if any DAG carries a scenario, the batch gets stacked
    `FaultArrays` (neutral for healthy rows — exact multiply-by-one, so
    those rows stay element-wise identical to an all-healthy batch).
    """
    assert len(ops_list) == len(st_list)
    dev = resolve_device(device)
    n_max = max(o.n_ops for o in ops_list)
    r_max = max(o.n_resources for o in ops_list)
    perms = [None if exact else scan_order(o, s)
             for o, s in zip(ops_list, st_list)]
    batch = OpArrays.stack([
        OpArrays.from_micro_ops(o, pad_to=n_max, perm=p, device=dev)
        for o, p in zip(ops_list, perms)])
    fbatch = None
    if any(faulted(o) for o in ops_list):
        fbatch = FaultArrays.stack([
            FaultArrays.from_micro_ops(o, n_resources=r_max, pad_to=n_max,
                                       perm=p, device=dev)
            for o, p in zip(ops_list, perms)])
    st_vecs = _st_tensor(np.stack([st_to_vec(s) for s in st_list]), dev)
    makespan, _ = simulate_arrays(batch, st_vecs, n_resources=r_max,
                                  exact=exact, f=fbatch)
    return makespan.cpu().numpy()


def sweep_service_times(ops: MicroOps, st_vecs: np.ndarray, *,
                        st_ref: Optional[ServiceTimes] = None,
                        exact: bool = False, device: DeviceLike = "cuda"
                        ) -> np.ndarray:
    """What-if hardware sweep (§2.1): one DAG, many ServiceTimes vectors."""
    dev = resolve_device(device)
    perm = None if exact else scan_order(ops, st_ref or PAPER_RAMDISK)
    c = st_vecs.shape[0]
    batch = OpArrays.from_micro_ops(ops, perm=perm, device=dev).expand(c)
    fbatch = None
    if faulted(ops):
        fbatch = FaultArrays.from_micro_ops(ops, perm=perm, device=dev).expand(c)
    makespan, _ = simulate_arrays(batch, _st_tensor(st_vecs, dev),
                                  n_resources=ops.n_resources, exact=exact,
                                  f=fbatch)
    return makespan.cpu().numpy()
