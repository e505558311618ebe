"""Predictor-guided checkpoint configuration (the Scenario-I question asked
of the training cluster: how should the checkpoint storage layer be
configured for this job?).

Given the training state's total bytes, the number of writer hosts and
the identified service times, sweep (stripe width x chunk size x
replication x placement) with the batched simulator and return the
predicted-fastest configuration meeting the redundancy requirement.

The sweep runs on a `SweepSession`'s engine: ``session=`` when given,
else the process default session on the card (``device="cuda"``, the
default, raising when no card is present) or a private session on the
device the caller names (``device="cpu"`` runs the plain PyTorch path).
The winner is confirmed, and its restore predicted, by the exact DES
oracle (`ref_sim`) on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import ref_sim
from ..core.sweep import InlineBackend, SweepSession, default_session
from ..core.types import MB, ServiceTimes, StorageConfig, collocated_config
from ..core.workloads import checkpoint_restore, checkpoint_write
from ..env import DeviceLike, resolve_device


@dataclass
class CheckpointPlan:
    config: StorageConfig
    local_placement: bool
    predicted_write_s: float
    predicted_restore_s: float
    table: List[Dict]                  # full sweep for the report


def _session(session: Optional[SweepSession],
             device: DeviceLike) -> SweepSession:
    if session is not None:
        return session
    dev = resolve_device(device)
    if dev.type == "cuda":
        return default_session()
    return SweepSession(InlineBackend(), device=dev)


def plan_checkpoint(total_bytes: int, n_hosts: int, st: ServiceTimes, *,
                    min_replication: int = 1,
                    chunk_sizes: Sequence[int] = (1 * MB, 4 * MB, 16 * MB),
                    stripe_widths: Sequence[int] = (0, 1, 4),
                    verify_best: bool = True,
                    session: Optional[SweepSession] = None,
                    device: DeviceLike = "cuda") -> CheckpointPlan:
    """Sweep checkpoint-storage configs; optimize predicted write time and
    report predicted restore (broadcast) time for the winner."""
    sess = _session(session, device)
    n_writers = n_hosts - 1
    shard = max(total_bytes // max(n_writers, 1), 1)

    cands: List[Tuple[StorageConfig, bool]] = []
    for ck in chunk_sizes:
        for sw in stripe_widths:
            for repl in {min_replication, min(min_replication + 1, n_writers)}:
                for local in ((True, False) if repl == 1 else (False,)):
                    # local placement pins both replicas to one node — only
                    # valid when redundancy is not required
                    cfg = collocated_config(n_hosts, stripe_width=sw,
                                            replication=repl, chunk_size=ck)
                    cands.append((cfg, local))

    # structure-keyed DAG cache: repeat planner invocations (same cluster,
    # new job) skip Python DAG construction entirely
    cache = sess.compile_cache
    ops_list = [cache.get(checkpoint_write(n_writers, shard, local=loc), cfg)
                for cfg, loc in cands]
    with sess.lock:
        times = sess.engine.simulate_batch(ops_list, [st] * len(cands))
    order = np.argsort(times)
    table = [{"stripe": cands[i][0].stripe_width,
              "chunk_mb": cands[i][0].chunk_size / MB,
              "replication": cands[i][0].replication,
              "local": cands[i][1],
              "predicted_write_s": float(times[i])} for i in order]

    best_i = int(order[0])
    if verify_best:   # exact-mode confirmation of the winner
        t_best = ref_sim.simulate(ops_list[best_i], st).makespan
    else:
        t_best = float(times[best_i])
    best_cfg, best_local = cands[best_i]

    restore_ops = cache.get(
        checkpoint_restore(n_writers, shard,
                           replication=best_cfg.replication), best_cfg)
    t_restore = ref_sim.simulate(restore_ops, st).makespan

    return CheckpointPlan(config=best_cfg, local_placement=best_local,
                          predicted_write_s=t_best,
                          predicted_restore_s=t_restore, table=table)
