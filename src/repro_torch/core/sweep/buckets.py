"""Shape bucketing for cached batched sweeps.

A configuration grid produces DAGs whose op counts vary smoothly with
the candidate's knobs (more storage nodes => more chunk ops), so
batching each grid to its own max op count would mint a new batch shape
(and a new kernel specialisation and device batch) on every sweep.
Instead we round every shape axis up to a power of two:

    * ``n_ops``       -> next power of two (floor 16)
    * ``n_resources`` -> next power of two (floor 8)
    * batch size      -> next power of two (floor 1)

Candidates sharing a ``(n_ops_bucket, n_resources_bucket)`` bucket run in
one batched call; a whole Scenario-I/II grid touches a handful of
buckets, and repeat sweeps (what-if loops, successive halving rounds,
advisor re-runs) hit the engine's caches. Padding is free in the
model: padded ops are zero-duration no-ops on the dummy resource, padded
resources are never referenced, padded batch rows are sliced off.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..compile import MicroOps

OPS_FLOOR = 16
RES_FLOOR = 8


def bucket_pow2(n: int, floor: int = OPS_FLOOR) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), floor, 1)
    return 1 << (n - 1).bit_length()


def bucket_of(ops: MicroOps) -> Tuple[int, int]:
    """(padded op count, padded resource count) for one compiled DAG."""
    n_ops, n_resources = ops.shape_signature
    return (bucket_pow2(n_ops, OPS_FLOOR), bucket_pow2(n_resources, RES_FLOOR))


def group_by_bucket(ops_list: Sequence[MicroOps]) -> Dict[Tuple[int, int], List[int]]:
    """Indices of `ops_list` grouped by their shape bucket (stable order)."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, ops in enumerate(ops_list):
        groups.setdefault(bucket_of(ops), []).append(i)
    return groups
