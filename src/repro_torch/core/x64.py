"""The simulators' float type: f64, or f32 under ``REPRO_SIM_X64=0``.

The counterpart of `repro.core.x64`. The simulators run in f64 (times in
seconds need more than f32's 7 digits to reproduce the oracle's FIFO
tie-breaking). ``REPRO_SIM_X64=0`` is the operator's switch to f32, the
mode the reference's TPU kernel ran in: scan-mode tie-breaking is then no
longer bit-faithful, but scan must still agree with exact mode within the
golden fixture tolerance (`tests/test_torch_x64.py`).

PyTorch names every dtype explicitly, so there is no context manager:
the simulator's constructors take the dtype `sim_dtype` returns, read at
the point where the reference rounds its f64 NumPy arrays to the device
(`torch_sim.DeviceOrder.arrays`, `FaultArrays.neutral`, `st_tensor`),
and the sweep engine reads it once per batch call, so a batch never
mixes the two.
"""
from __future__ import annotations

import os

import torch


def x64_wanted() -> bool:
    """False when the operator pinned the simulators to f32
    (``REPRO_SIM_X64=0``). Read per call, so tests can flip it without
    reloading modules."""
    return os.environ.get("REPRO_SIM_X64", "1") != "0"


def sim_dtype() -> torch.dtype:
    """``torch.float64``, or ``torch.float32`` under ``REPRO_SIM_X64=0``."""
    return torch.float64 if x64_wanted() else torch.float32
