"""Elastic scaling + fault tolerance control plane — the counterpart of
`repro.launch.elastic`.

At 1000+ node scale the failure model is: a pod (or a slice of one)
drops; the job must (1) detect, (2) re-derive a coherent smaller mesh,
(3) restore the latest manifest-complete checkpoint — re-sharding the
state for the new mesh — and (4) continue, all without human action.

This module implements the control logic; the
detection signal is injectable (heartbeat timeouts in production, a
callback here). The restore I/O pattern is the paper's broadcast
benchmark, so `checkpoint.planner` sizes its replication level with the
predictor: replication >= 2 lets a restore proceed even when the
checkpoint's own storage nodes died with the pod.

The reference's `resharded_state`, which re-places a restored state with
a new mesh's NamedShardings, waits for the port's sharding layer
(ROADMAP Queue A item 12).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..core.faults import from_pod_health


@dataclass
class PodHealth:
    n_pods: int
    alive: List[bool] = field(default_factory=list)
    last_heartbeat: List[float] = field(default_factory=list)
    timeout_s: float = 60.0

    def __post_init__(self):
        if not self.alive:
            self.alive = [True] * self.n_pods
            self.last_heartbeat = [time.monotonic()] * self.n_pods

    def heartbeat(self, pod: int, now: Optional[float] = None) -> None:
        self.last_heartbeat[pod] = now if now is not None else time.monotonic()

    def sweep(self, now: Optional[float] = None) -> List[int]:
        """Mark pods dead on heartbeat timeout; returns newly-dead pods."""
        now = now if now is not None else time.monotonic()
        newly = []
        for p in range(self.n_pods):
            if self.alive[p] and now - self.last_heartbeat[p] > self.timeout_s:
                self.alive[p] = False
                newly.append(p)
        return newly

    @property
    def n_alive(self) -> int:
        return sum(self.alive)

    def to_fault_scenario(self, *, after_stage: Optional[str] = None,
                          after_tasks: Optional[int] = None,
                          extra_nodes: Sequence[int] = (),
                          name: str = "pods"):
        """The predictor-side view of this health state: a
        `core.FaultScenario` killing the storage rank of every
        dead pod (plus ``extra_nodes``), ready to drop into
        `StorageConfig(faults=...)` or a `grid(faults=...)` axis — e.g.
        to size restore-path replication against the failure that just
        happened (docs/faults.md)."""
        return from_pod_health(self, after_stage=after_stage,
                               after_tasks=after_tasks,
                               extra_nodes=extra_nodes, name=name)


@dataclass
class ElasticDecision:
    n_pods: int
    mesh_shape: tuple
    needs_restore: bool
    global_batch_scale: float     # keep per-chip batch constant


def plan_degraded_mesh(health: PodHealth) -> ElasticDecision:
    """Choose the largest coherent mesh from surviving pods. The model
    axis is never shrunk (sharding layouts stay valid); the pod/data
    product absorbs the loss, and the data loader rescales the global
    batch so per-chip batch (and therefore convergence behaviour per
    step) is preserved."""
    n = max(health.n_alive, 1)
    return ElasticDecision(
        n_pods=n,
        mesh_shape=(16, 16) if n == 1 else (n, 16, 16),
        needs_restore=n < health.n_pods,
        global_batch_scale=n / health.n_pods,
    )


class ElasticTrainer:
    """Drives detect -> degrade -> restore -> continue cycles."""

    def __init__(self, n_pods: int, checkpoint_manager, *, timeout_s: float = 60.0):
        self.health = PodHealth(n_pods=n_pods, timeout_s=timeout_s)
        self.ckpt = checkpoint_manager
        self.events: List[Dict] = []

    def on_failure(self, state_like, dead_pods: Sequence[int],
                   lost_storage_nodes: Sequence[int] = ()):
        """Handle pod loss: degrade the mesh and restore the latest
        checkpoint, reading around lost storage nodes via replicas."""
        for p in dead_pods:
            self.health.alive[p] = False
        decision = plan_degraded_mesh(self.health)
        state, step = self.ckpt.restore(state_like,
                                        lost_nodes=lost_storage_nodes)
        self.events.append({"dead_pods": list(dead_pods),
                            "resume_step": step,
                            "mesh": decision.mesh_shape,
                            "batch_scale": decision.global_batch_scale,
                            # the predictor-ready scenario for this event,
                            # so post-mortem sweeps can replay it
                            "fault_scenario": self.health.to_fault_scenario(
                                extra_nodes=lost_storage_nodes)})
        return state, step, decision
