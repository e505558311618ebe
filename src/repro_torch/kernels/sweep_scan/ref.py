"""Plain PyTorch version of the sweep-scan kernel: the FIFO service-time
accumulation `repro_torch.core.torch_sim._scan_once` runs, on raw
tensors.

A Python loop over the N op rows, vectorised over the candidate axis
(`gather` / `scatter_` on ``avail [C, R]`` and ``end [C, N]``). It runs
on whatever device its inputs lie on: the CPU tests and ``device="cpu"``
use it, and on the card it is what the CUDA kernel is held against. It
repeats the kernel's arithmetic step by step and is no yardstick of
speed. Raw-tensor signature (no `OpArrays` / core imports) keeps the
kernel package free of `repro_torch.core`.
"""
from __future__ import annotations

from typing import Tuple

import torch


def sweep_scan_ref(res: torch.Tensor, dur: torch.Tensor, lag: torch.Tensor,
                   deps: torch.Tensor, *, n_resources: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched (candidate-major) reference: res i32[C, N], dur/lag
    f64[C, N], deps i32[C, N, MAXD] (-1 = no dep) ->
    (makespan f64[C], end f64[C, N]).

    Each op starts at max(dep completion times, its resource's
    availability); the resource is then busy until start + dur, and the
    op completes ``lag`` later (network latency rides the completion
    time, not the queue). A dep that points at an op not yet served
    reads 0.0."""
    C, N = res.shape
    dev, dt = dur.device, dur.dtype
    avail = torch.zeros((C, n_resources), dtype=dt, device=dev)
    end = torch.zeros((C, N), dtype=dt, device=dev)
    makespan = torch.zeros((C,), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    res_idx = res.to(torch.int64)
    has_dep = deps >= 0
    dep_idx = deps.clamp(min=0).to(torch.int64)
    for i in range(N):
        dep_end = torch.where(has_dep[:, i], end.gather(1, dep_idx[:, i]), zero)
        ready = torch.maximum(dep_end.max(dim=1).values, zero)
        r = res_idx[:, i:i + 1]
        start = torch.maximum(ready, avail.gather(1, r).squeeze(1))
        fin = start + dur[:, i]
        avail.scatter_(1, r, fin.unsqueeze(1))
        end[:, i] = fin + lag[:, i]
        makespan = torch.maximum(makespan, fin)
    return makespan, end


def scan_serve(res: torch.Tensor, dur: torch.Tensor, lag: torch.Tensor,
               deps: torch.Tensor, n_resources: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One candidate: res i32[N], dur f64[N], lag f64[N],
    deps i32[N, MAXD] -> (makespan f64[], end f64[N])."""
    makespan, end = sweep_scan_ref(res[None], dur[None], lag[None], deps[None],
                                   n_resources=n_resources)
    return makespan[0], end[0]
