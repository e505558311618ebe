"""Checkpointing over an intermediate storage layer — the counterpart of
`repro.checkpoint.store`.

This is the framework integration of the paper: checkpoint writes are a
*pipeline-pattern* workload (every host persists its shard) and restores
are a *broadcast-pattern* workload — exactly the access patterns whose
performance the paper's predictor models. `planner.plan_checkpoint`
chooses the storage configuration (stripe width / chunk size / replication
/ placement) for the measured service times before any byte is written.

The store itself is real code: chunked, striped, manifest-committed,
hash-verified, crash-safe (manifest written last + atomic rename), with
node-loss recovery through replicas, on the port's own placement
`Manager`.

Checkpoints cross between the packages: each leaf is saved under its
`jax.tree_util.keystr` name (`tree.tree_paths`: ``.params['blocks']
['attn']['wq']``, ``.opt.count``), leaves go to writers by the same
greedy size balance over the same order, and ``count`` is a 0-d int32
array. bf16 leaves are saved as the 2-byte records NumPy writes for
JAX's bfloat16 arrays.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.placement import Manager
from ..core.types import StorageConfig
from ..tree import tree_map, tree_paths


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a tensor of ``like``'s dtype, device and ``requires_grad``."""
    if like.dtype == torch.bfloat16 and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device=like.device, dtype=like.dtype)
    return t.requires_grad_(like.requires_grad)


class IntermediateStore:
    """Node-local storage aggregation: one directory per storage node,
    files striped into chunks across nodes per the configured placement
    (the same `Manager` policy code the simulator models)."""

    def __init__(self, root: str, config: StorageConfig):
        self.root = root
        self.config = config
        self.mgr = Manager(config)
        for s in config.storage_hosts:
            os.makedirs(self._node_dir(s), exist_ok=True)

    def _node_dir(self, node: int) -> str:
        return os.path.join(self.root, f"node_{node:03d}")

    def _chunk_path(self, node: int, fname: str, j: int, replica: int) -> str:
        safe = fname.replace("/", "_")
        return os.path.join(self._node_dir(node), f"{safe}.c{j:05d}.r{replica}")

    def write(self, fname: str, data: bytes, writer_host: int,
              attr=None) -> Dict:
        loc = self.mgr.place(fname, len(data), writer_host, attr)
        cs = self.config.chunk_size
        chunk_map = []
        for j in range(loc.n_chunks):
            payload = data[j * cs:(j + 1) * cs]
            digest = hashlib.sha256(payload).hexdigest()[:16]
            for r, node in enumerate(loc.chunks[j]):
                with open(self._chunk_path(node, fname, j, r), "wb") as f:
                    f.write(payload)
            chunk_map.append({"nodes": loc.chunks[j], "sha": digest,
                              "size": len(payload)})
        return {"name": fname, "size": len(data), "chunks": chunk_map}

    def read(self, entry: Dict, *, lost_nodes: Sequence[int] = ()) -> bytes:
        """Reassemble a file; fall back to replicas for lost nodes."""
        out = io.BytesIO()
        for j, ch in enumerate(entry["chunks"]):
            payload = None
            for r, node in enumerate(ch["nodes"]):
                if node in lost_nodes:
                    continue
                path = self._chunk_path(node, entry["name"], j, r)
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        payload = f.read()
                    break
            if payload is None:
                raise IOError(f"chunk {j} of {entry['name']} unrecoverable "
                              f"(lost nodes {list(lost_nodes)})")
            if hashlib.sha256(payload).hexdigest()[:16] != ch["sha"]:
                raise IOError(f"chunk {j} of {entry['name']} corrupt")
            out.write(payload)
        return out.getvalue()


@dataclass
class CheckpointManager:
    """Sharded, manifest-committed checkpoints of a `TrainState` tree."""

    root: str
    store: IntermediateStore
    n_writers: int

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.root, f"manifest_{step:08d}.json")

    def save(self, state, step: int) -> Dict:
        """Write ``state`` (tensors on any device, copied to the host one
        writer's shard at a time) as checkpoint ``step``; returns the
        manifest."""
        leaves = tree_paths(state)
        shards: List[List[Tuple[str, Any]]] = [[] for _ in range(self.n_writers)]
        sizes = [0] * self.n_writers
        for path, leaf in sorted(leaves, key=lambda kv: -_nbytes(kv[1])):
            w = int(np.argmin(sizes))          # greedy size balancing
            shards[w].append((path, leaf))
            sizes[w] += _nbytes(leaf)

        t0 = time.monotonic()
        entries = []
        for w, shard in enumerate(shards):
            buf = io.BytesIO()
            np.savez(buf, **{p: _to_numpy(l) for p, l in shard})
            writer_host = self.store.config.client_hosts[
                w % len(self.store.config.client_hosts)]
            entries.append(self.store.write(f"step{step:08d}/shard{w:04d}",
                                            buf.getvalue(), writer_host))
        manifest = {"step": step, "n_writers": self.n_writers,
                    "entries": entries, "wall_s": time.monotonic() - t0}
        tmp = self._manifest_path(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, self._manifest_path(step))   # atomic commit
        return manifest

    def latest_step(self) -> Optional[int]:
        steps = []
        for fn in os.listdir(self.root):
            if fn.startswith("manifest_") and fn.endswith(".json"):
                steps.append(int(fn[len("manifest_"):-len(".json")]))
        return max(steps) if steps else None

    def restore(self, like, step: Optional[int] = None, *,
                lost_nodes: Sequence[int] = ()):
        """Rebuild the state tree: structure, dtype, device and
        ``requires_grad`` of each leaf taken from ``like``; the leaves are
        new tensors, ready for a step. Returns (state, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.root}")
        with open(self._manifest_path(step)) as f:
            manifest = json.load(f)
        arrays: Dict[str, np.ndarray] = {}
        for entry in manifest["entries"]:
            data = self.store.read(entry, lost_nodes=lost_nodes)
            with np.load(io.BytesIO(data)) as z:
                arrays.update({k: z[k] for k in z.files})
        state = tree_map(lambda path, leaf: _from_numpy(arrays[path], leaf),
                         like, with_path=True)
        return state, step
