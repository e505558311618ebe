"""The device trace of a ``--trace 1`` run, from `torch.profiler`.

The profiler records the card's activity (kernels, copies, memsets) and
the host's torch operations over the measured window. Its timestamps are
mapped onto the window by an annotation made at the window's start, and
the program's spans (`obs.Tracer`, on the host clock) by the same
anchor. From that:

* ``busy_s``: the length of the union of device activity in the window;
* kernel time by name (the ``device_ops`` breakdown), and the kernels
  alone (a kernel's roofline is over kernel time, not copies);
* the idle time inside requests (the harness annotates each request
  where requests do not overlap), which is the host's part of them;
* idle time split by what the host was doing: a program span if one
  covers it (the innermost, brackets dropped: ``compile_grid``, ``prep``),
  else the outermost host torch operation, else inside or outside a
  request (the harness annotates each request).
"""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

ANCHOR = "bench.window_start"
REQUEST = "bench.request"
TOP = 10


@dataclass
class Interval:
    name: str
    start: float          # seconds since the window's start
    dur: float

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclass
class TraceData:
    window_s: float
    device: List[Interval] = field(default_factory=list)    # all activity
    kernels: List[Interval] = field(default_factory=list)   # kernels only
    host_ops: List[Interval] = field(default_factory=list)  # outermost aten ops
    requests: List[Interval] = field(default_factory=list)
    spans: List[Interval] = field(default_factory=list)     # program spans

    @property
    def busy_s(self) -> float:
        return union_length(self.device, 0.0, self.window_s)

    @property
    def kernel_s(self) -> float:
        return union_length(self.kernels, 0.0, self.window_s)

    @property
    def idle_in_requests_s(self) -> float:
        """Seconds inside a request with nothing running on the card:
        the host's part of the requests."""
        inside = _merged(self.requests, 0.0, self.window_s)
        busy = _merged(self.device, 0.0, self.window_s)
        return (sum(b - a for a, b in inside)
                - _overlap_length(inside, busy))

    def device_ops(self) -> List[list]:
        by: Dict[str, float] = {}
        for k in self.device:
            by[k.name] = by.get(k.name, 0.0) + k.dur
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], s] for n, s in top]

    def idle_by_host(self) -> List[list]:
        return [[n, s] for n, s in idle_by_label(self)[:TOP]]


def _merged(iv: Sequence[Interval], lo: float, hi: float
            ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted((max(i.start, lo), min(i.end, hi)) for i in iv):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap_length(x: List[Tuple[float, float]],
                    y: List[Tuple[float, float]]) -> float:
    """The length two sorted lists of disjoint intervals share."""
    out, i, j = 0.0, 0, 0
    while i < len(x) and j < len(y):
        out += max(0.0, min(x[i][1], y[j][1]) - max(x[i][0], y[j][0]))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def union_length(iv: Sequence[Interval], lo: float, hi: float) -> float:
    return sum(b - a for a, b in _merged(iv, lo, hi))


def _tier(iv: Sequence[Interval], innermost: bool):
    """Non-overlapping (starts, ends, names) of a set of intervals: the
    outermost of nested ones, or with ``innermost`` the shortest that
    covers each point (program spans nest)."""
    order = sorted(iv, key=lambda i: (i.dur if innermost else -i.dur))
    taken: List[Interval] = []
    starts: List[float] = []
    for i in order:                     # fill every gap it covers
        a = i.start
        while a < i.end:
            k = bisect.bisect_right(starts, a)
            if k and taken[k - 1].end > a:
                a = taken[k - 1].end
                continue
            b = min(i.end, starts[k] if k < len(starts) else float("inf"))
            if b > a:
                taken.insert(k, Interval(i.name, a, b - a))
                starts.insert(k, a)
            a = b
    return (np.array([t.start for t in taken]), np.array([t.end for t in taken]),
            [t.name for t in taken])


def idle_by_label(t: TraceData) -> List[Tuple[str, float]]:
    """Idle device seconds summed by what the host was doing."""
    busy = _merged(t.device, 0.0, t.window_s)
    bounds = {0.0, t.window_s}
    tiers = [_tier([Interval(re.sub(r"\[.*\]$", "", s.name), s.start, s.dur)
                    for s in t.spans], innermost=True),
             _tier(t.host_ops, innermost=False),
             _tier([Interval("host: in a request, outside torch ops",
                             r.start, r.dur) for r in t.requests], False)]
    for a, b in busy:
        bounds.update((a, b))
    for st, en, _ in tiers:
        bounds.update(np.clip(st, 0.0, t.window_s).tolist())
        bounds.update(np.clip(en, 0.0, t.window_s).tolist())
    edges = np.array(sorted(bounds))
    mid = (edges[:-1] + edges[1:]) / 2
    length = np.diff(edges)
    if busy:
        bs = np.array([a for a, _ in busy])
        be = np.array([b for _, b in busy])
        k = np.searchsorted(bs, mid, side="right") - 1
        idle = ~((k >= 0) & (mid < be[np.maximum(k, 0)]))
    else:
        idle = np.ones(len(mid), dtype=bool)
    label = np.full(len(mid), -1)
    names: List[str] = []
    for st, en, nm in tiers:
        if len(st) == 0:
            continue
        k = np.searchsorted(st, mid, side="right") - 1
        hit = (k >= 0) & (mid < en[np.maximum(k, 0)]) & (label < 0)
        base = len(names)
        names.extend(nm)
        label[hit] = base + k[hit]
    out: Dict[str, float] = {}
    for lab, ln in zip(label[idle].tolist(), length[idle].tolist()):
        key = names[lab] if lab >= 0 else "host: harness, between requests"
        out[key] = out.get(key, 0.0) + ln
    return sorted(out.items(), key=lambda kv: -kv[1])


class DeviceTrace:
    """`torch.profiler` over the window. ``start`` at the window's start,
    `request` around each request, ``stop`` once the last answer is in."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self._prof = None
        self.t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        with record_function(ANCHOR):
            pass

    def request(self):
        from torch.profiler import record_function
        return record_function(REQUEST)

    def stop(self, t_end: float, program_spans=(), span_epoch: float = 0.0
             ) -> TraceData:
        """``t_end`` on the host clock; ``program_spans`` are `obs.Span`s
        whose ``start`` counts from ``span_epoch`` on the same clock."""
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        evs = list(self._prof.profiler.kineto_results.events())
        anchor = [e for e in evs if e.name() == ANCHOR
                  and "CUDA" not in str(e.device_type())]
        if not anchor:
            raise RuntimeError("the profiler lost the window's anchor")
        a_ns = anchor[0].start_ns()
        data = TraceData(window_s=t_end - self.t0)
        cpu_ops: List[Tuple[int, Interval]] = []
        for e in evs:
            iv = Interval(e.name(), (e.start_ns() - a_ns) / 1e9,
                          e.duration_ns() / 1e9)
            if iv.name in (ANCHOR, REQUEST) or e.is_user_annotation():
                if iv.name == REQUEST and "CUDA" not in str(e.device_type()):
                    data.requests.append(iv)
            elif "CUDA" in str(e.device_type()):
                data.device.append(iv)
                if not iv.name.startswith(("Memcpy", "Memset")):
                    data.kernels.append(iv)
            elif iv.name.startswith("aten::"):
                cpu_ops.append((e.start_thread_id(), iv))
        cpu_ops.sort(key=lambda ti: (ti[0], ti[1].start, -ti[1].dur))
        end_by_thread: Dict[int, float] = {}
        for tid, iv in cpu_ops:
            if iv.start >= end_by_thread.get(tid, float("-inf")):
                data.host_ops.append(iv)
                end_by_thread[tid] = iv.end
        shift = span_epoch - self.t0
        data.spans = [Interval(s.name, s.start + shift, s.dur)
                      for s in program_spans]
        return data
