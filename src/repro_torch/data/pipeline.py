"""Synthetic sharded data pipeline with straggler-mitigation hooks — the
port's own copy of `repro.data.pipeline`, which imports `jax` but uses
NumPy only. The batches are the reference's to the bit (the same NumPy
generators, drawn in the same order); the trainer moves them to its
device.

Production shape: each data-parallel host group draws its local batch
shard; a bounded-staleness prefetch queue hides input latency, and the
dispatcher skips persistently slow shards (straggler mitigation) while
keeping the global batch size constant by resampling from healthy shards.
The "hosts" are simulated, but the control logic (the part that matters
at 1000-node scale) is real and unit-tested.
"""
from __future__ import annotations

import collections
import threading
import queue
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from ..models.config import ArchConfig, ShapeConfig


@dataclass
class PipelineConfig:
    prefetch: int = 2
    straggler_factor: float = 3.0      # shard flagged if > factor x median latency
    straggler_window: int = 8          # sliding latency window per shard
    min_healthy: float = 0.5           # never drop below this fraction of shards


def synth_batch(cfg: ArchConfig, shape: ShapeConfig, rng: np.random.Generator,
                batch_override: Optional[int] = None) -> Dict[str, np.ndarray]:
    """One synthetic global batch with a learnable structure (token t+1
    depends on t) so smoke-training shows loss decreasing."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    v = cfg.vocab
    # Markov-ish stream: x_{t+1} = (x_t * 31 + noise) % v
    x0 = rng.integers(0, v, size=(B, 1))
    noise = rng.integers(0, 7, size=(B, S))
    toks = np.zeros((B, S + 1), np.int64)
    toks[:, :1] = x0
    for t in range(S):
        toks[:, t + 1] = (toks[:, t] * 31 + noise[:, t]) % v
    batch: Dict[str, np.ndarray] = {
        "labels": toks[:, 1:].astype(np.int32),
        "mask": np.ones((B, S), np.float32),
    }
    if cfg.frontend in ("audio", "vlm"):
        # stub frontend: precomputed frame/patch embeddings stand in for
        # the modality encoder output
        emb = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        batch["embeds"] = emb
    else:
        batch["tokens"] = toks[:, :-1].astype(np.int32)
    return batch


class ShardStats:
    def __init__(self, window: int):
        self.lat: collections.deque = collections.deque(maxlen=window)
        self.dropped = False

    def push(self, dt: float):
        self.lat.append(dt)

    @property
    def median(self) -> float:
        return float(np.median(self.lat)) if self.lat else 0.0


class DataPipeline:
    """Prefetching dispatcher over `n_shards` simulated input shards."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, n_shards: int, *,
                 pipe_cfg: Optional[PipelineConfig] = None, seed: int = 0,
                 shard_delay: Optional[Callable[[int, int], float]] = None):
        if shape.global_batch % n_shards and shape.global_batch != 1:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {n_shards} shards")
        pipe_cfg = pipe_cfg or PipelineConfig()
        self.cfg, self.shape, self.n = cfg, shape, n_shards
        self.pcfg = pipe_cfg
        self.rngs = [np.random.default_rng(seed + 7 * s) for s in range(n_shards)]
        self.stats = [ShardStats(pipe_cfg.straggler_window) for _ in range(n_shards)]
        self.shard_delay = shard_delay or (lambda shard, step: 0.0)
        self.step = 0

    # -- straggler mitigation -----------------------------------------------------
    def healthy_shards(self) -> List[int]:
        meds = [s.median for s in self.stats if s.lat]
        if not meds:
            return list(range(self.n))
        global_med = float(np.median(meds))
        healthy = [i for i, s in enumerate(self.stats)
                   if not s.lat or s.median <= self.pcfg.straggler_factor * max(global_med, 1e-9)]
        floor = max(int(self.n * self.pcfg.min_healthy), 1)
        if len(healthy) < floor:        # never starve the batch
            order = sorted(range(self.n), key=lambda i: self.stats[i].median)
            healthy = order[:floor]
        return healthy

    def next_batch(self) -> Dict[str, np.ndarray]:
        """Assemble the global batch from healthy shards (slow shards'
        share is resampled from healthy ones — constant global batch)."""
        healthy = self.healthy_shards()
        B = self.shape.global_batch
        per = max(B // self.n, 1)
        parts = []
        for i in range(self.n):
            src = i if i in healthy else healthy[i % len(healthy)]
            dt = self.shard_delay(src, self.step)
            self.stats[src].push(dt)
            parts.append(synth_batch(self.cfg, self.shape, self.rngs[src],
                                     batch_override=per))
        self.step += 1
        out = {k: np.concatenate([p[k] for p in parts])[:B] for k in parts[0]}
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.pcfg.prefetch)
        stop = threading.Event()

        def producer():
            while not stop.is_set():
                try:
                    q.put(self.next_batch(), timeout=0.5)
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
