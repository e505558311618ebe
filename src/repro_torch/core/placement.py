"""Data-placement policies (§2.2) — the manager-side decision of where a
new file's chunks (and their replicas) live.

The manager is modeled as the paper describes: a round-robin cursor over
the storage-node list for default striping, plus per-file policy
overrides carried in the workload description (local / collocate /
broadcast).

Fault awareness (docs/faults.md): the workload compiler `kill()`s
storage hosts as the configured `FaultScenario` triggers, and every
placement decision from then on excludes the dead set — new stripes,
replica chains and collocate targets land on survivors only. Files
placed *before* a death keep their chains; the read side fails over via
`pick_replica`. With no kills the live list is exactly
``storage_hosts`` and every decision is bit-identical to the healthy
path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Optional, Tuple

import numpy as np

from .types import FileAttr, Placement, StorageConfig


@dataclass
class FileLoc:
    """Resolved location of one stored file: per-chunk replica chains.

    ``chunks[j]`` is the ordered list of storage-host ids holding replica
    0..r-1 of chunk j (replica 0 is the primary written by the client;
    replicas follow in a chain, matching the storage-component forwarding
    in the model).
    """

    size: int
    chunk_size: int
    chunks: List[List[int]]

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @cached_property
    def default_replicas(self) -> np.ndarray:
        """int64[n_chunks]: the replica chunk j is read from while no host
        is dead or degraded, replica ``j mod r`` (`Manager.pick_replica`),
        or -1 where the chain is empty. Chains do not change once placed,
        so a file read many times computes this once."""
        return np.fromiter((c[j % len(c)] if c else -1
                            for j, c in enumerate(self.chunks)),
                           np.int64, self.n_chunks)

    def chunk_bytes(self, j: int) -> int:
        last = self.size - (self.n_chunks - 1) * self.chunk_size
        return self.chunk_size if j < self.n_chunks - 1 else max(last, 0)

    def single_host(self) -> Optional[int]:
        # a chunk with no surviving chain (all storage dead) has no host
        if any(not c for c in self.chunks):
            return None
        hosts = {c[0] for c in self.chunks}
        return hosts.pop() if len(hosts) == 1 else None


class Manager:
    """Placement state machine. Deterministic, so the workload compiler
    can resolve placement ahead of simulation (the simulated manager
    *service time* still charges per request)."""

    def __init__(self, config: StorageConfig):
        self.config = config
        self.cursor = 0
        self.collocate_targets: Dict[str, int] = {}
        self.files: Dict[str, FileLoc] = {}
        self.dead: set = set()        # storage hosts lost to the fault scenario

    def kill(self, host: int) -> None:
        """Mark a storage host dead: excluded from every placement made
        from now on (already-placed chains are untouched — reads fail
        over through `pick_replica`)."""
        self.dead.add(host)

    # -- helpers ------------------------------------------------------------
    def _live(self) -> List[int]:
        if not self.dead:                       # healthy fast path, bit-identical
            return list(self.config.storage_hosts)
        return [h for h in self.config.storage_hosts if h not in self.dead]

    def _stripe_set(self, width: int) -> List[int]:
        s = self._live()
        if not s:
            self.cursor += 1                    # cursor semantics stay deterministic
            return []
        start = self.cursor % len(s)
        self.cursor += 1
        return [s[(start + i) % len(s)] for i in range(min(width, len(s)))]

    def _replica_chain(self, primary: int, r: int) -> List[int]:
        s = self._live()
        i = s.index(primary)
        return [s[(i + k) % len(s)] for k in range(min(r, len(s)))]

    # -- the placement decision ----------------------------------------------
    def place(self, name: str, size: int, writer_host: int,
              attr: Optional[FileAttr]) -> FileLoc:
        cfg = self.config
        policy = (attr.placement if attr and attr.placement else cfg.placement)
        repl = (attr.replication if attr and attr.replication else cfg.replication)
        n_chunks = -(-size // cfg.chunk_size)   # 0-size files carry no chunks (§2.5)

        if policy == Placement.LOCAL and writer_host in cfg.storage_hosts \
                and writer_host not in self.dead:
            targets: List[Optional[int]] = [writer_host] * n_chunks
        elif policy == Placement.COLLOCATE:
            group = (attr.collocate_group if attr and attr.collocate_group else name)
            tgt = self.collocate_targets.get(group)
            if tgt is None or tgt in self.dead:   # (re)pick among survivors
                s = self._stripe_set(1)
                tgt = s[0] if s else None
                if tgt is not None:
                    self.collocate_targets[group] = tgt
            targets = [tgt] * n_chunks
        else:  # ROUND_ROBIN and BROADCAST stripe over the configured width
            width = min(cfg.stripe_width, len(cfg.storage_hosts))
            stripe = self._stripe_set(width)
            targets = [stripe[j % len(stripe)] if stripe else None
                       for j in range(n_chunks)]

        # a None target means no storage node survives: the chunk gets an
        # empty chain and the compiler emits a *dead op* for its store
        loc = FileLoc(size=size, chunk_size=cfg.chunk_size,
                      chunks=[self._replica_chain(t, repl) if t is not None
                              else [] for t in targets])
        self.files[name] = loc
        return loc

    def lookup(self, name: str) -> FileLoc:
        return self.files[name]

    def pick_replica(self, chain: List[int], j: int,
                     degraded: Optional[Dict[int, float]] = None) -> Optional[int]:
        """Read-side replica choice for chunk ``j`` with chain ``chain``.

        Healthy path: the paper's load-balancing pick, replica ``j mod
        r`` — reproduced exactly (the min below is stable and every key
        ties at 1.0). Under faults: dead replicas are skipped, and among
        survivors the *least degraded* is preferred (the manager knows
        node health — the cross-layer-hint reading of arXiv 1301.6195 —
        so a replica on a healthy disk shields readers from a degraded
        primary; this is what lets replication earn its cost in degraded
        sweeps). Returns None when no replica survives — the read is
        unservable and the run fails.
        """
        if not chain:
            return None
        k = j % len(chain)
        order = chain[k:] + chain[:k]      # default pick first, stable rotation
        live = [h for h in order if h not in self.dead]
        if not live:
            return None
        if not degraded:
            return live[0]
        return min(live, key=lambda h: degraded.get(h, 1.0))

    def storage_used(self) -> int:
        total = 0
        for loc in self.files.values():
            for j in range(loc.n_chunks):
                total += loc.chunk_bytes(j) * len(loc.chunks[j])
        return total
