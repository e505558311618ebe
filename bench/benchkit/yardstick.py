"""Peaks of the card and the work a scan needs, counted from the plain
reference's DAGs (never from the program's).

The scan of one profile over one DAG of N ops needs, per op: its
duration (two multiplies, two adds), its lag (one multiply), its ready
time (one max per dependency; the first against the 0.0 floor), its
start (a max with the resource's free time), its finish and completion
(two adds) and the running makespan (a max): ``9 + deps`` f64
operations. Its inputs, each byte read once: the DAG (res 4, class 1,
bytes, requests, extra seconds and lag flag 8 each, four dependency ids
4 each: 53 bytes an op), each profile's seven f64 rates, and one f64
makespan out per profile. However the program lays the work out (a copy
of the DAG per profile, durations in a pass of their own, or all of it
in one kernel), this count stays what the work needs.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense, at the 700 W limit:
3.35 TB/s of HBM3, and 33.5 TFLOP/s in f64 outside the tensor cores (the
scan's maxes and adds run there; the tensor cores cannot take them).
That figure counts a fused multiply-add as two operations. The scan's
operations are single adds, multiplies and maxes (the program builds its
kernel with ``-fmad=false``, and a max cannot fuse), one instruction
each, so they issue at half of it: 16.75e12 a second.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_OPS_PER_S = 33.5e12 / 2      # one unfused f64 instruction each

DAG_BYTES_PER_OP = 4 + 1 + 8 * 4 + 4 * 4
PROFILE_BYTES = 7 * 8
MAKESPAN_BYTES = 8


@dataclass(frozen=True)
class ScanWork:
    rows: int             # ops x profiles
    ops: float            # f64 operations
    bytes: float          # inputs read once, makespans written once

    @property
    def bound_s(self) -> float:
        """The least time the card could take, and which roof sets it."""
        return max(self.ops / PEAK_F64_OPS_PER_S,
                   self.bytes / PEAK_BYTES_PER_S)

    @property
    def bound_by(self) -> str:
        return ("ops" if self.ops / PEAK_F64_OPS_PER_S
                >= self.bytes / PEAK_BYTES_PER_S else "bytes")

    def __add__(self, other: "ScanWork") -> "ScanWork":
        return ScanWork(self.rows + other.rows, self.ops + other.ops,
                        self.bytes + other.bytes)


def scan_work(dag: dict, profiles: int) -> ScanWork:
    """The work of scanning ``profiles`` profiles over one reference DAG
    (`reference.compiler.compile_dag`)."""
    n = int(dag["res"].shape[0])
    deps = int(np.count_nonzero(dag["deps"] >= 0))
    return ScanWork(rows=n * profiles, ops=float((9 * n + deps) * profiles),
                    bytes=float(DAG_BYTES_PER_OP * n
                                + (PROFILE_BYTES + MAKESPAN_BYTES) * profiles))


NO_WORK = ScanWork(0, 0.0, 0.0)
