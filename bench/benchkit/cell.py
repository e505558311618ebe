"""One run of one cell: set-up, the measured window, the trace, the
correctness checks and the result line.

The window is a closed loop: each client sends its next request when
its last answer is in, until ``seconds`` have passed; the requests in
flight then finish (a minute past the close at most) and the window ends
with the last answer. So every request sent counts, and a rate is all
the work over all the time. The program's state is freed before the
plain reference checks a sample of the answers.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import itertools
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import spec
from .devtrace import DeviceTrace, TraceData

# what may not be loaded in the process that prints a result
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
LATE_S = 60.0           # how long past the close an answer is waited for
CHECK_STREAM = 0xC4EC   # the seed's stream for the sample that is checked


class NoDevice(RuntimeError):
    """The cards this cell asks for are not there."""


class ForbiddenModules(RuntimeError):
    """The process loaded JAX or the JAX package."""


@dataclass
class Record:
    """One request of the window."""

    k: int                        # its index in the mix's sequence
    client: int
    t_submit: float               # host clock
    t_answer: float = float("nan")
    predictions: int = 0
    ok: bool = False
    answer: Any = None
    error: str = ""

    @property
    def latency_s(self) -> float:
        return self.t_answer - self.t_submit


@dataclass
class RunInfo:
    """What the metric readers read."""

    cell: spec.Cell
    setup_s: float
    window_s: float
    records: List[Record]
    trace: Optional[TraceData] = None
    program_spans: list = field(default_factory=list)   # window-relative
    work: Any = None              # the cell driver's yardstick count (traced)


def forbidden_loaded() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def sample_records(records, n: int, rng, key):
    """``n`` records drawn from ``rng``, the one with the largest ``key``
    (the longest request) always among them."""
    if not records:
        return []
    longest = max(range(len(records)), key=lambda i: key(records[i]))
    rest = [i for i in range(len(records)) if i != longest]
    take = rng.permutation(len(rest))[:max(n - 1, 0)].tolist()
    return [records[longest]] + [records[rest[i]] for i in take]


def resolve_device(chips: int, device: Optional[str]) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} cards, the cell asks "
                       f"for {chips}")
    return torch.device("cuda")


async def _closed_loop(driver, clients: int, seconds: float,
                       dtrace: Optional[DeviceTrace]):
    seq = itertools.count()
    records: List[Record] = []
    t0 = time.perf_counter()
    close = t0 + seconds

    async def one(c: int) -> None:
        while time.perf_counter() < close:
            rec = Record(k=next(seq), client=c, t_submit=time.perf_counter())
            records.append(rec)
            # annotated for the trace where requests do not overlap
            mark = (dtrace.request() if dtrace is not None and clients == 1
                    else contextlib.nullcontext())
            try:
                with mark:
                    rec.predictions, rec.answer = await asyncio.wait_for(
                        driver.issue(rec.k, c),
                        max(close + LATE_S - time.perf_counter(), 0.0) + 1e-3)
                rec.ok = True
            except Exception as exc:          # the answer never came
                rec.error = f"{type(exc).__name__}: {exc}"[:500]
            rec.t_answer = time.perf_counter()

    await asyncio.gather(*(one(c) for c in range(clients)))
    t_end = max([r.t_answer for r in records] + [time.perf_counter()])
    return records, t0, t_end


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = spec.ROOT, t_start: Optional[float] = None,
             device: Optional[str] = None) -> Dict[str, Any]:
    """Run one cell once and return its result line as a dict (with
    ``checks`` last). ``device`` None asks for the cards the cell names;
    tests pass ``"cpu"``."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("start", t_start)]
    cell = spec.load_cell(root, workload)
    dev = resolve_device(int(cell.workload["chips"]), device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.zeros(1, device=dev)          # the CUDA context
    marks.append(("torch and CUDA", time.perf_counter()))
    tracer = None
    if trace:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    driver = cell.driver_module().Driver(cell, seed, dev, tracer)
    marks.append(("program import", time.perf_counter()))
    reported = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: cell.reader(m["name"]) for m in reported}
    clients = int(cell.mix["clients"])

    async def measured():
        await driver.setup()
        if cuda:
            torch.cuda.synchronize()
        dtrace = DeviceTrace(cuda) if trace else None
        t_w0 = time.perf_counter()
        if dtrace is not None:
            dtrace.start()
        records, t0, t_end = await _closed_loop(driver, clients, seconds,
                                                dtrace)
        data = None
        if dtrace is not None:
            data = dtrace.stop(t_end, tracer.spans(),
                               time.perf_counter() - tracer.now())
        await driver.close()
        return t_w0 - t_start, records, t0, t_end, data

    setup_s, records, t0, t_end, data = asyncio.run(measured())
    marks.append(("program set-up", t0))
    print("set-up: " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b)
                                 in zip(marks, marks[1:])), file=sys.stderr)
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    spans = []
    if tracer is not None:          # onto the window's clock
        shift = time.perf_counter() - tracer.now() - t0
        spans = [dataclasses.replace(s, start=s.start + shift)
                 for s in tracer.spans()]
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    info = RunInfo(cell=cell, setup_s=setup_s, window_s=t_end - t0,
                   records=records, trace=data, program_spans=spans)
    if trace:
        info.work = driver.work(records)
    metrics: Dict[str, Dict[str, Any]] = {}
    for m in reported:
        value = readers[m["name"]].read(info)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    rng = np.random.default_rng([seed, CHECK_STREAM])
    readings = driver.check([r for r in records if r.ok], rng)
    readings["failed_requests"] = sum(not r.ok for r in records)
    checks = {}
    for name, lim in cell.limits["checks"].items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": lim["limit"]}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    bad = forbidden_loaded()
    if bad:
        raise ForbiddenModules(f"loaded: {', '.join(bad)}")

    if cuda:
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                    "count": int(cell.workload["chips"]),
                    "memory_peak_bytes": memory_peak}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": memory_peak}
    if data is not None:
        dev_info["busy_s"] = data.busy_s
        dev_info["window_s"] = data.window_s
    out: Dict[str, Any] = {
        "correct": bool(correct), "attempted": len(records),
        "failed": sum(not r.ok for r in records), "metrics": metrics,
        "device": dev_info}
    if data is not None:
        out["breakdown"] = {"device_ops": data.device_ops(),
                            "idle_gaps": data.idle_by_host()}
    out["checks"] = checks
    return out
