"""Device-sharded sweep execution: partition the candidate batch axis,
counterpart of `repro.core.sweep.shard`.

A bucket's batch is embarrassingly parallel across candidates, so this
module splits the *batch axis* of each bucket over a 1-D device mesh:

    batch [C_pad, ...] --S contiguous row slices--> C_pad/S rows per device

* The port's mesh is a tuple of `torch.device`, the counterpart of the
  reference's 1-D ``jax.sharding.Mesh`` over axis ``"candidates"``
  (`make_candidates_mesh` builds one). It holds the largest
  power-of-two prefix of the chosen devices (``resolve_mesh``), so
  power-of-two batch buckets always divide the shard count —
  remainders are absorbed by the *existing* bucket padding
  (`SweepEngine` pads ``c_pad = max(pow2(C), S)``), never by a new
  bucket key.
* Per-candidate simulation is row-independent, so the sharded callable
  (`sharded_executable`: each slice runs the bucket's callable on its
  own device, the slices concatenate back in candidate order on the
  engine's device) is **bit-identical** to the one-device path —
  asserted element-wise by tests/test_torch_shard.py across batch sizes
  straddling device-count boundaries. On CUDA devices the slices are
  enqueued one after the other, each on its device's current stream,
  so on distinct cards they are expected to run side by side; no run
  has measured that yet (the port has been run on one card only).
* With one visible device (or ``devices=None``) everything falls back to
  the plain callable: same cache keys (shards=1), zero behaviour change.

An explicit device sequence may name one device more than once. The
slots are then split all the same, each slice run in turn on that one
device: that is how the sharded path is exercised on a CPU-only host
(``[torch.device("cpu")] * 8``, where the reference forces 8 host
devices with ``--xla_force_host_platform_device_count=8``) and on a
one-card machine (``[cuda:0, cuda:0]``). Such a mesh tests the split; it
measures nothing about multi-GPU speed.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from ...env import DeviceLike, resolve_device
from .buckets import bucket_pow2

# the port's sweep mesh: the devices of the candidate axis, in order
Mesh = Tuple[torch.device, ...]

# what SweepEngine accepts as its ``devices`` option
DevicesLike = Union[None, int, Sequence[DeviceLike]]


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (0 for n < 1)."""
    return 1 << (n.bit_length() - 1) if n >= 1 else 0


def _pinned(device: DeviceLike) -> torch.device:
    """``device`` resolved (raising for CUDA on a host without a card),
    with a CUDA device's index made explicit so that identities and
    counters name one card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_candidates_mesh(devices: Sequence[DeviceLike]) -> Mesh:
    """A 1-D sweep mesh over ``devices``, in the order given."""
    return tuple(_pinned(d) for d in devices)


def resolve_mesh(devices: DevicesLike, device: DeviceLike = "cuda"
                 ) -> Optional[Mesh]:
    """Normalize a ``devices`` option into a 1-D sweep mesh (or None)
    for an engine on ``device``.

    * ``None``            -> None (one-device fallback)
    * ``0``               -> all visible devices of the engine's type
                             (`torch.cuda.device_count()` cards for a CUDA
                             engine; a CPU engine has one device, so None)
    * ``n > 0``           -> the first n of those
    * a device sequence   -> those devices, repeats allowed (see the
                             module docstring), all of the engine's type

    Device counts are rounded *down* to a power of two (so every
    power-of-two batch bucket divides the shard count evenly); a
    resolved count of one returns None — splitting over one device
    would only add dispatch overhead over the plain callable.
    """
    if devices is None:
        return None
    kind = torch.device(device).type
    if isinstance(devices, int):
        if devices < 0:
            raise ValueError(f"devices must be >= 0, got {devices}")
        # every device of the engine's type: each card, or the one host
        avail = ([torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())]
                 if kind == "cuda" else [torch.device(kind)])
        devs: Sequence[DeviceLike] = avail if devices == 0 \
            else avail[:devices]
    else:
        devs = list(devices)
        for d in devs:
            if torch.device(d).type != kind:
                raise ValueError(f"mesh device {str(d)!r} is not of the "
                                 f"engine's type {kind!r}")
    n = pow2_floor(len(devs))
    if n <= 1:
        return None
    return make_candidates_mesh(devs[:n])


def shard_count(mesh: Optional[Mesh]) -> int:
    """Number of batch-axis shards an engine mesh implies (1 = no mesh)."""
    return 1 if mesh is None else len(mesh)


def shard_pad(n: int, n_shards: int) -> int:
    """Batch-bucket size for n candidates over n_shards devices.

    The plain power-of-two batch bucket, floored at the shard count:
    because the shard count is itself a power of two, padding up to it
    keeps the batch divisible without inventing new bucket sizes.
    """
    return max(bucket_pow2(n, floor=1), n_shards)


def _rows(arrays, rows: slice, device: torch.device):
    """One contiguous row slice of every leaf of an `OpArrays` /
    `FaultArrays` batch, on ``device``."""
    return type(arrays)(*(getattr(arrays, n)[rows].to(device)
                          for n in arrays._NAMES))


def sharded_executable(fn: Callable[..., torch.Tensor], mesh: Mesh,
                       home: torch.device) -> Callable[..., torch.Tensor]:
    """The bucket callable ``fn(batch, st_vecs, fbatch, *, stats)`` split
    over the batch axis: slice k of C_pad/S rows of every `OpArrays`
    leaf, of the service-time matrix and (for faulted buckets) of every
    `FaultArrays` leaf runs ``fn`` on ``mesh[k]``; the makespans
    concatenate back in candidate order on ``home`` (the engine's
    device). ``fn`` must be a per-row-independent map, which every
    bucket callable is."""
    n = len(mesh)

    def run(batch, st_vecs: torch.Tensor, fbatch=None, *,
            stats=None) -> torch.Tensor:
        m = st_vecs.shape[0] // n
        outs = []
        for k, dev in enumerate(mesh):
            rows = slice(k * m, (k + 1) * m)
            outs.append(fn(_rows(batch, rows, dev), st_vecs[rows].to(dev),
                           None if fbatch is None
                           else _rows(fbatch, rows, dev), stats=stats))
        return torch.cat([o.to(home) for o in outs])
    return run


def mesh_identity(mesh: Optional[Mesh]):
    """Hashable identity used to detect mesh changes (sharded callables
    close over their mesh, so a different device set invalidates them)."""
    if mesh is None:
        return None
    return tuple(str(d) for d in mesh)


def slot_names(mesh: Mesh) -> List[str]:
    """The ``device_rows`` key of each mesh slot: the device's name, or,
    where the mesh names a device more than once, the name with the
    slot's index (``"cpu[3]"``), so every slot is counted apart."""
    names = [str(d) for d in mesh]
    if len(set(names)) == len(names):
        return names
    return [f"{s}[{k}]" for k, s in enumerate(names)]
