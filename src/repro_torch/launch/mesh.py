"""Production meshes, as `torch.distributed` device meshes — the
counterpart of `repro.launch.mesh`.

Defined as functions (not module constants), so importing this module
touches no device and no process group: the dry run builds its meshes
over a fake process group of 256 or 512 ranks that it sets up itself,
while a test or a one-card run builds them over its own group. Each
function needs an initialised process group whose world size is the
mesh's size, and raises without one. The 1-D mesh over explicit devices
that the sweep layer shards candidates over is
`repro_torch.core.sweep.shard.make_candidates_mesh`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mk(shape: Sequence[int], axes: Sequence[str],
        device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs an initialised process group "
            "(torch.distributed.init_process_group) of world size "
            f"{_size(shape)}")
    world = dist.get_world_size()
    if world != _size(shape):
        raise RuntimeError(f"a {tuple(shape)} mesh needs world size "
                           f"{_size(shape)}, the process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _size(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: 16x16 = 256 devices, axes (data, model). Multi-pod: 2
    pods = 512 devices, axes (pod, data, model) — the "pod" axis spans
    the boundary between pods and carries only data-parallel traffic."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device_type)


def make_elastic_mesh(n_pods: int, *, data: int = 16, model: int = 16,
                      device_type: str = "cuda") -> DeviceMesh:
    """Degraded mesh after pod loss (see launch.elastic): same per-pod
    topology, fewer pods. n_pods == 1 drops the pod axis entirely so
    collective layouts match the single-pod program."""
    if n_pods == 1:
        return _mk((data, model), ("data", "model"), device_type)
    return _mk((n_pods, data, model), ("pod", "data", "model"), device_type)


def make_host_mesh(*, model: Optional[int] = None,
                   device_type: str = "cuda") -> DeviceMesh:
    """Whatever the process group spans — for tests and one-card runs:
    (world // model, model), axes (data, model)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    m = model or 1
    if n % m:
        raise ValueError(f"world size {n} is not a multiple of model={m}")
    return _mk((n // m, m), ("data", "model"), device_type)
