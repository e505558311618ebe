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
reproduce the oracle's FIFO tie-breaking), or f32 under
``REPRO_SIM_X64=0`` (`core.x64`). The compiled DAG's arrays are f64 and
are rounded to `x64.sim_dtype()` where they become a batch's rows, as
the reference's ``jnp.asarray`` does: on the rows' device
(`DeviceOrder.arrays`); the fault multipliers and the service-time
vectors are rounded on the host; every step after that runs in that
dtype. The estimated-start order is f64 in either mode.
Each constructor below names its dtype because `torch.zeros(n)` alone
is f32. Each arithmetic step is its own eager PyTorch op, in the
reference's order, so scan-mode results are element-wise equal to the
reference's (no fused multiply-add can creep in).

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
from ..obs.timeline import Timeline
from ..obs.trace import NULL_TRACER
from .compile import (CLS_CLIENT, CLS_MANAGER, CLS_NET_LOCAL, CLS_NET_REMOTE,
                      CLS_STORAGE, N_CLS, MicroOps)
from .faults import DEAD_TIME
from .ref_sim import durations as _ref_durations
from .ref_sim import rate_tables as _rate_tables_np
from .types import PAPER_RAMDISK, RunReport, ServiceTimes
from .x64 import sim_dtype

# service-time vector layout
(ST_NET_REMOTE, ST_NET_LOCAL, ST_NET_LATENCY, ST_STORAGE, ST_MANAGER,
 ST_CLIENT, ST_STORAGE_REQ) = range(7)


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
    per DAG by `DeviceOrder.arrays` with shapes ``[N]`` / ``[N, MAXD]``;
    `stack` / `batched` / `expand` add the leading candidate axis the
    simulator works on."""

    res: torch.Tensor      # i32[N]   (the sweep-scan kernel reads i32)
    cls: torch.Tensor      # i64[N]   (an index tensor: int8 cannot index)
    nbytes: torch.Tensor   # f[N]     (f64, or f32: `x64.sim_dtype`)
    reqs: torch.Tensor     # f[N]
    extra: torch.Tensor    # f[N]
    nlat: torch.Tensor     # f[N]
    deps: torch.Tensor     # i32[N, MAXD]

    _NAMES = ("res", "cls", "nbytes", "reqs", "extra", "nlat", "deps")

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

    res_mult: torch.Tensor   # f[R] service-time multiplier per resource
    dead: torch.Tensor       # f[N] 1.0 = unservable op (costs DEAD_TIME)

    _NAMES = ("res_mult", "dead")

    @classmethod
    def neutral(cls, n_ops: int, n_resources: int, *,
                device: DeviceLike = "cuda",
                dtype: Optional[torch.dtype] = None) -> "FaultArrays":
        """All-ones / all-zeros arrays for healthy rows batched alongside
        faulted ones: multiplying by 1.0 and adding 0.0 are exact in
        f64 and in f32, so a healthy row simulated through the faulted
        path is element-wise identical to the healthy path's result.
        ``dtype`` (default `x64.sim_dtype()`) must be the batch's."""
        dev = resolve_device(device)
        dt = sim_dtype() if dtype is None else dtype
        return cls(res_mult=torch.ones(n_resources, dtype=dt, device=dev),
                   dead=torch.zeros(n_ops, dtype=dt, device=dev))

    @classmethod
    def stack(cls, rows: Sequence["FaultArrays"]) -> "FaultArrays":
        return cls(*(torch.stack([getattr(r, n) for r in rows])
                     for n in cls._NAMES))

    def batched(self) -> "FaultArrays":
        return FaultArrays(self.res_mult[None], self.dead[None])

    def expand(self, c: int) -> "FaultArrays":
        return FaultArrays(*(t[None].expand(c, *t.shape).contiguous()
                             for t in _fields(self, self._NAMES)))


def _np_float(dtype: Optional[torch.dtype]) -> type:
    """The NumPy float type the host rounds its f64 arrays to before
    they become tensors of ``dtype`` (default `x64.sim_dtype()`)."""
    dt = sim_dtype() if dtype is None else dtype
    if dt == torch.float64:
        return np.float64
    if dt == torch.float32:
        return np.float32
    raise TypeError(f"the simulators run in float64 or float32, not {dt}")


def _res_mult(ops: MicroOps, n_resources: Optional[int], dev: torch.device,
              dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The per-resource multipliers, padded with 1.0 to ``n_resources``
    (default the DAG's) and rounded to ``dtype`` on the host."""
    rm = np.ones(n_resources or ops.n_resources, dtype=np.float64)
    if ops.res_mult is not None:
        rm[:ops.n_resources] = ops.res_mult
    return torch.from_numpy(rm.astype(_np_float(dtype))).to(dev)


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


# the relaxation in `_card_order` looks for its fixpoint once every
# this many steps (one host sync each); steps past the fixpoint change
# nothing, so a check can come late but never early
RELAX_CHECK_EVERY = 8


def _relax_starts(deps: torch.Tensor, dur: torch.Tensor
                  ) -> Optional[torch.Tensor]:
    """Estimated starts ``f64[N]`` of a DAG whose deps ``i32[N, MAXD]``
    all point at earlier ops, by Jacobi relaxation to the fixpoint
    (`_card_order`); None if it is not reached within n + 1
    steps, which only a NaN made on the way can cause. Three eager ops
    a step: a gather of the deps' ends from a table whose slot 0 holds
    0.0 (a missing dep, and one more slot an op, so the ``max`` floors
    at 0.0), the ``max``, the ``+``."""
    n, width = deps.shape[0], deps.shape[1] + 1
    dev = dur.device
    idx = torch.zeros((n, width), dtype=deps.dtype, device=dev)
    idx[:, 1:] = deps + 1
    idx = idx.view(-1)
    ends = torch.zeros(n + 1, dtype=torch.float64, device=dev)
    nxt = torch.zeros_like(ends)
    got = torch.empty(n * width, dtype=torch.float64, device=dev)
    start = torch.empty(n, dtype=torch.float64, device=dev)
    for step in range(1, n + 2):
        torch.index_select(ends, 0, idx, out=got)
        torch.amax(got.view(n, width), dim=1, out=start)
        torch.add(start, dur, out=nxt[1:])
        if (step % RELAX_CHECK_EVERY == 0 or step == n + 1) \
                and torch.equal(ends, nxt):
            return start
        ends, nxt = nxt, ends
    return None


def _orders_on_card(dev: torch.device) -> bool:
    """Does `estimated_order` build a scan-mode row's order on ``dev``
    (`_card_order`) rather than on the host (`scan_order`)? The
    relaxation does O(n x depth) work: a few ms on a card, slower than
    the level pass on a host CPU."""
    return dev.type == "cuda"


@dataclass
class DeviceOrder:
    """One DAG copied to the rows' device as it was compiled
    (unpermuted), the order its rows take there, and whether the device
    built that order (`estimated_order` makes it). `arrays` permutes,
    renumbers, pads and rounds the rows on that device: the one row
    builder, whatever the order's source."""

    ops: MicroOps
    perm: torch.Tensor            # i64[N] estimated-start order (op order in
                                  # exact mode)
    on_card: bool                 # the device built ``perm`` (`_card_order`)
    res: torch.Tensor             # i32[N]
    cls: torch.Tensor             # i64[N]
    nbytes: torch.Tensor          # f64[N]
    reqs: torch.Tensor            # f64[N]
    extra: torch.Tensor           # f64[N]
    nlat: torch.Tensor            # f64[N]
    deps: torch.Tensor            # i32[N, MAXD]
    dead: Optional[torch.Tensor]  # f64[N], faulted DAGs only

    def arrays(self, pad_to: Optional[int] = None,
               n_resources: Optional[int] = None, *,
               dtype: Optional[torch.dtype] = None
               ) -> Tuple[OpArrays, Optional[FaultArrays]]:
        """The DAG's rows in ``perm`` order: `OpArrays`, and for a
        faulted DAG `FaultArrays` (None for a healthy one). Gathered on
        the device, deps renumbered through the inverse permutation,
        padded to ``pad_to`` ops with 0 (deps -1, padded ops alive) and
        to ``n_resources`` multipliers with 1.0, floats rounded to
        ``dtype`` (default `x64.sim_dtype()`) there."""
        ops, perm = self.ops, self.perm
        dev = perm.device
        fdt = sim_dtype() if dtype is None else dtype
        _np_float(fdt)                               # f64 or f32 only
        n = ops.n_ops
        m = pad_to or n
        assert m >= n

        def take(t: torch.Tensor, dt: torch.dtype, fill=0) -> torch.Tensor:
            out = torch.full((m,) + tuple(t.shape[1:]), fill, dtype=dt,
                             device=dev)
            out[:n] = t.index_select(0, perm)
            return out

        # slot 0 maps "no dep" (-1 + 1) to -1; slot k + 1 op k to its place
        inv = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
        inv[perm + 1] = torch.arange(n, dtype=torch.int32, device=dev)
        deps = inv.index_select(0, (self.deps + 1).view(-1)).view_as(self.deps)
        arr = OpArrays(res=take(self.res, torch.int32),
                       cls=take(self.cls, torch.int64),
                       nbytes=take(self.nbytes, fdt), reqs=take(self.reqs, fdt),
                       extra=take(self.extra, fdt), nlat=take(self.nlat, fdt),
                       deps=take(deps, torch.int32, fill=-1))
        if not faulted(ops):
            return arr, None
        dead = (take(self.dead, fdt) if self.dead is not None
                else torch.zeros(m, dtype=fdt, device=dev))
        return arr, FaultArrays(res_mult=_res_mult(ops, n_resources, dev, fdt),
                                dead=dead)


def _card_order(d: DeviceOrder, st_ref: ServiceTimes
                ) -> Optional[torch.Tensor]:
    """The estimated-start permutation of ``d``'s DAG, built on its
    device, or None where the host must build it: a dep that points at
    a later op (`scan_order`'s loop reads 0.0 for it), or a duration
    that is not finite (one check, one host sync).

    The estimated starts are the fixpoint of a Jacobi relaxation: each
    step sets every op's start to the ``max`` of 0.0 and its deps' ends,
    and its end to start + duration. With every dep pointing at an
    earlier op the fixpoint is unique, and each op holds there the same
    ``max`` of the same operands plus the same duration as in
    `_scan_order_levels`; the stable sort then gives the same
    permutation. An op at depth d is final after d + 1 steps, so the
    steps stop within n + 1. The starts are f64 whatever `x64.sim_dtype`
    says, as the host's are."""
    ops, dev = d.ops, d.res.device
    # one eager op a step, in `ref_sim.durations`' order, then
    # `scan_order`'s lag: nothing fuses a multiply into an add
    brate, rrate = (torch.tensor(t, device=dev)
                    for t in _rate_tables_np(st_ref))
    dur = (d.nbytes * brate.index_select(0, d.cls)
           + d.reqs * rrate.index_select(0, d.cls) + d.extra)
    if ops.res_mult is not None:
        dur = dur * torch.tensor(ops.res_mult,
                                 device=dev).index_select(0, d.res)
    if d.dead is not None:
        dur = dur + d.dead * DEAD_TIME
    dur = dur + d.nlat * st_ref.net_latency
    ahead = torch.arange(ops.n_ops, dtype=d.deps.dtype, device=dev)[:, None]
    if not bool(torch.isfinite(dur).all() & (d.deps < ahead).all()):
        return None
    start = _relax_starts(d.deps, dur)
    if start is None:
        return None
    # + 0.0 turns -0.0 into 0.0: the host's sort takes them as equal,
    # and a radix sort need not
    return torch.sort(start + 0.0, stable=True).indices


def estimated_order(ops: MicroOps, st_ref: Optional[ServiceTimes],
                    device: DeviceLike = "cuda") -> DeviceOrder:
    """One DAG on ``device`` with the order its rows take there: op
    order where ``st_ref`` is None (exact mode); else the
    estimated-start order against ``st_ref``, built on the device where
    `_orders_on_card` says so and the DAG allows it (`_card_order`),
    and by `scan_order` on the host otherwise. The one place the order's
    source is chosen; the two give the same permutation."""
    dev = resolve_device(device)

    def up(a: np.ndarray) -> torch.Tensor:
        # one copy straight from the array (which a DAG cache may
        # have made read-only) to the device
        return torch.tensor(a, device=dev)

    d = DeviceOrder(ops=ops, perm=torch.arange(ops.n_ops, device=dev),
                    on_card=False, res=up(ops.res),
                    cls=up(ops.cls).to(torch.int64), nbytes=up(ops.nbytes),
                    reqs=up(ops.reqs), extra=up(ops.extra), nlat=up(ops.nlat),
                    deps=up(ops.deps),
                    dead=up(ops.dead) if ops.dead is not None else None)
    if st_ref is None:
        return d
    perm = _card_order(d, st_ref) if _orders_on_card(dev) else None
    d.on_card = perm is not None
    d.perm = perm if d.on_card else torch.from_numpy(
        scan_order(ops, st_ref)).to(dev, torch.int64)
    return d


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


def _scan_once(a: OpArrays, dur: torch.Tensor, lag: torch.Tensor,
               n_resources: int, use_kernel: bool = True, stats=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    # the FIFO serving recurrence itself lives in kernels/sweep_scan:
    # the CUDA kernel for CUDA tensors, the plain loop for CPU tensors
    # (or everywhere with use_kernel=False); the kernel counts its
    # launches in ``stats``
    return sweep_scan_ops.sweep_scan(
        a.res.contiguous(), dur.contiguous(), lag.contiguous(),
        a.deps.contiguous(), n_resources=n_resources, use_kernel=use_kernel,
        stats=stats)


def _sim_scan(a: OpArrays, st_vecs: torch.Tensor, n_resources: int,
              f: Optional[FaultArrays] = None, *, use_kernel: bool = True,
              stats=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fast mode: one pass of the FIFO serving recurrence over the rows
    in the order they were built in (`estimated_order`), which stands in
    for arrival order. Exact mode, or the search layer's scan -> exact
    verification, gives the faithful schedule."""
    dur, lag = _durations(a, st_vecs, f)
    return _scan_once(a, dur, lag, n_resources, use_kernel, stats)


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
                    use_kernel: bool = True, stats=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched arrays in, (makespan [C], per-op completion times incl.
    lag [C, N]) out. ``f=None`` is the healthy path and never touches
    fault tensors. ``use_kernel`` (False: the plain loop on any device)
    and ``stats`` (where the kernel counts its launches, the engine's
    `CacheStats`) only matter in scan mode."""
    if exact:
        return _sim_exact(a, st_vecs, n_resources, f)
    return _sim_scan(a, st_vecs, n_resources, f, use_kernel=use_kernel,
                     stats=stats)


def st_tensor(vecs: np.ndarray, dev: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Service-time vectors ``[C, 7]`` on ``dev``, rounded to ``dtype``
    (default `x64.sim_dtype()`) on the host."""
    return torch.from_numpy(np.ascontiguousarray(
        vecs, dtype=np.float64).astype(_np_float(dtype))).to(dev)


def simulate(ops: MicroOps, st: ServiceTimes, *, exact: bool = False,
             timeline: bool = False, device: DeviceLike = "cuda",
             use_kernel: bool = True, stats=None) -> RunReport:
    """Drop-in equivalent of `ref_sim.simulate` running on ``device``.

    ``timeline=True`` additionally attaches an `obs.timeline.Timeline`
    to the report: per-op start/end intervals in original op order,
    ``end`` from the scan (the kernel's second output on a card),
    ``dur`` and ``lag`` recomputed on the host exactly as the device
    summed them, and ``start = end - lag - dur`` in f64 in that order.
    Its critical path explains the makespan.

    ``use_kernel`` / ``stats``: as in `simulate_arrays`
    (`SweepEngine.simulate_one` passes its engine's)."""
    dev = resolve_device(device)
    dt = sim_dtype()
    order = estimated_order(ops, None if exact else st, dev)
    a, fa = order.arrays(dtype=dt)
    makespan, end = simulate_arrays(a.batched(),
                                    st_tensor(st_to_vec(st)[None], dev, dt),
                                    n_resources=ops.n_resources, exact=exact,
                                    f=None if fa is None else fa.batched(),
                                    use_kernel=use_kernel, stats=stats)
    makespan = float(makespan[0].cpu())
    # row i is op perm[i]: put each op's end back in its place
    end = torch.empty_like(end[0]).index_copy_(0, order.perm, end[0])
    end = end.cpu().numpy()
    per_task = {tid: float(end[op]) for tid, op in ops.task_end_op.items()}
    per_stage: Dict[str, float] = {}
    for tid, t_end in per_task.items():
        s = ops.stage_of_task.get(tid, "")
        per_stage[s] = max(per_stage.get(s, 0.0), t_end)
    tl = None
    if timeline:
        dur = _ref_durations(ops, st)        # fault-adjusted, host-side
        lag = ops.nlat * st.net_latency
        start = end - lag - dur
        tl = Timeline(start=start, dur=dur, lag=lag, end=end,
                      res=ops.res, cls=ops.cls, deps=ops.deps,
                      makespan=makespan, n_resources=ops.n_resources)
    return RunReport(makespan=makespan, bytes_moved=ops.bytes_moved,
                     storage_used=ops.storage_used, per_task_end=per_task,
                     per_stage_end=per_stage, n_events=ops.n_ops,
                     timeline=tl)


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
    dt = sim_dtype()
    n_max = max(o.n_ops for o in ops_list)
    r_max = max(o.n_resources for o in ops_list)
    rows = [estimated_order(o, None if exact else s, dev).arrays(
                n_max, r_max, dtype=dt)
            for o, s in zip(ops_list, st_list)]
    batch = OpArrays.stack([a for a, _ in rows])
    fbatch = None
    if any(f is not None for _, f in rows):
        neutral = FaultArrays.neutral(n_max, r_max, device=dev, dtype=dt)
        fbatch = FaultArrays.stack([neutral if f is None else f
                                    for _, f in rows])
    st_vecs = st_tensor(np.stack([st_to_vec(s) for s in st_list]), dev, dt)
    makespan, _ = simulate_arrays(batch, st_vecs, n_resources=r_max,
                                  exact=exact, f=fbatch)
    return makespan.cpu().numpy()


def sweep_service_times(ops: MicroOps, st_vecs: np.ndarray, *,
                        st_ref: Optional[ServiceTimes] = None,
                        exact: bool = False, device: DeviceLike = "cuda",
                        tracer=None, stats=None) -> np.ndarray:
    """What-if hardware sweep (§2.1): one DAG, many ServiceTimes vectors.
    ``tracer`` records the prep (``what_if.scan_order``: the DAG's
    copy to ``device`` and its order, ``on_card`` 1 where the device
    built the order, see `estimated_order`; ``what_if.arrays``: the
    rows, `DeviceOrder.arrays`) and the scan with
    its copy back (``what_if.scan``); ``stats`` counts kernel launches,
    as in `simulate_arrays`."""
    tracer = NULL_TRACER if tracer is None else tracer
    dev = resolve_device(device)
    dt = sim_dtype()
    t0 = tracer.clock()
    order = estimated_order(ops, None if exact else (st_ref or PAPER_RAMDISK),
                            dev)
    tracer.record("what_if.scan_order", t0, tracer.clock(),
                  phase="host-prep", on_card=int(order.on_card))
    c = st_vecs.shape[0]
    with tracer.span("what_if.arrays", phase="host-prep"):
        arr, farr = order.arrays(dtype=dt)
        batch = arr.expand(c)
        fbatch = None if farr is None else farr.expand(c)
        sv = st_tensor(st_vecs, dev, dt)
    with tracer.span("what_if.scan", phase="device-sim"):
        makespan, _ = simulate_arrays(batch, sv, n_resources=ops.n_resources,
                                      exact=exact, f=fbatch, stats=stats)
        return makespan.cpu().numpy()
