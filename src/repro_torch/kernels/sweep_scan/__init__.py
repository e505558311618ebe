"""FIFO service-time scan for the sweep engine's hot loop.

`ops.sweep_scan` is the public entry: the batched (candidate-major)
serving recurrence of `repro_torch.core.torch_sim._scan_once`. On a CUDA
tensor it launches the hand-written Hopper kernel
(`csrc/sweep_scan.cu`, built and bound by `kernel.py`); on a CPU tensor
it runs the plain PyTorch version in `ref.py`. The two are element-wise
equal (only `max` and `+` in f64, in one order).
"""
from .ops import (cuda_supported, launch_count, reset_launch_count,  # noqa: F401
                  sweep_scan)
from .ref import scan_serve, sweep_scan_ref                           # noqa: F401
